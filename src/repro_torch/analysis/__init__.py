"""Analysis of the port's runs: the roofline terms on the NVIDIA H100.

The reference's `hlo_stats` parses XLA HLO, which PyTorch does not make;
its counterpart (a reader of torch.profiler traces) and `flops_model` (LM
FLOPs) wait for the LM substrate.
"""
from repro_torch.analysis.roofline import H100, H100_HBM_BYTES, HW, RooflineTerms, roofline_from_stats

__all__ = ["H100", "H100_HBM_BYTES", "HW", "RooflineTerms", "roofline_from_stats"]
