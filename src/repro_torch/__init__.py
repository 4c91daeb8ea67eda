"""PyTorch/CUDA port of the ridge-regularized matching solver.

Mirrors the JAX package `repro` module for module; every Pallas kernel of
the reference becomes a kernel written by hand for NVIDIA Hopper (sm_90a).
Imports torch and numpy only.
"""
