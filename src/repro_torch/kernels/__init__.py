"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

  csrc/primal_common.cuh  device functions all three kernels share: widening
                          loads, the primal candidate, the warp-segment and
                          wide-row Duchi projections (one rounding contract),
                          the slab walks of one launch per call, and the
                          launch scaffolding
  csrc/dual_oracle.cu     one-pass fused dual oracle, A x in int64 fixed
                          point, and its finalize (CUDA C++, sm_90a)
  csrc/dual_primal.cu     fused primal step, x only (CUDA C++, sm_90a)
  csrc/simplex_proj.cu    masked simplex projection (CUDA C++, sm_90a)
  build.py                nvcc at first use into build/kernels/, loaded by ctypes
  dual_oracle.py          each kernel's wrapper: checks, the plan built once
  dual_primal.py            per objective (dual_oracle.plan_slabs), and a
                            `launches` counter
  simplex_proj.py
  ref.py                  plain PyTorch versions (CPU path, ground truth)
  ops.py                  routing: CPU -> plain version, CUDA -> kernel
"""
from repro_torch.kernels.ops import (
    fused_dual_oracle,
    fused_dual_primal,
    fused_project_simplex,
)

__all__ = ["fused_dual_oracle", "fused_dual_primal", "fused_project_simplex"]
