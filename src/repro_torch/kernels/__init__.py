"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

  csrc/dual_oracle.cu  one-pass fused dual oracle (CUDA C++, sm_90a)
  build.py             nvcc at first use into build/kernels/, loaded by ctypes
  dual_oracle.py       the kernel's wrapper: checks, launch plan, counter
  ref.py               plain PyTorch versions (CPU path, ground truth)
  ops.py               routing: CPU -> plain version, CUDA -> kernel
"""
