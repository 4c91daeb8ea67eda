"""The benchmark's plain reference: float64 PyTorch from the paper's
equations, importing nothing of the program."""
