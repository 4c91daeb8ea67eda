"""Python wrapper of the hand-written Hopper primal-step kernel (csrc/dual_primal.cu).

Replaces the Pallas kernel `repro/kernels/dual_primal.py::dual_primal_kernel_body`
for CUDA tensors: x = Pi_simplex(-(A^T lam + c) / gamma) for every bucket
of an objective, with x as the only output.  The plan is the oracle's
(`dual_oracle.plan_slabs` with kernel "dual_primal"): built once per
objective, it checks the slabs, puts every bucket of width <= 32 in one
launch (wider buckets one launch each), stages lam in shared memory when it
fits beside the wide rows' scratch (else lam is read through L1/L2, so no
instance is too large), and sizes the persistent grid with the occupancy
API.  `primal_call` allocates the x slabs, launches on the current stream
and counts each launch in `launches`; `dual_primal` is the single-bucket
call of the sweeps and the per-bucket times.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.objective import inv_gamma
from repro_torch.kernels.dual_oracle import (
    _DTYPE_CODES,
    Slab,
    SlabPlan,
    _check_lam,
    _fn,
    _outputs,
    _require,
    check_slab,
    plan_slabs,
)

__all__ = ["dual_primal", "launches", "primal_call"]

launches = 0  # kernel launches since import (reset freely by callers)


def primal_call(plan: SlabPlan, lam: torch.Tensor, gamma: float) -> tuple[torch.Tensor, ...]:
    """One primal call of a "dual_primal" plan: the x slabs in the storage
    dtype (fp32 for int8)."""
    global launches
    _require(plan.kernel == "dual_primal", f"a {plan.kernel} plan", "dual_primal")
    dev = plan.device
    _check_lam("dual_primal", lam, plan.m * plan.J, dev)
    xs, ptrs = _outputs(plan)
    with torch.cuda.device(dev):
        rc = _fn("dual_primal_run")(
            plan.slab_words, len(plan.shapes), plan.launch_words, len(plan.launches),
            _DTYPE_CODES[plan.dtype], plan.M, plan.m, plan.J, lam.data_ptr(), ptrs,
            inv_gamma(gamma), plan.radius, int(plan.inequality),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dual_primal kernel launch failed: CUDA error {rc}")
    launches += len(plan.launches)
    return tuple(xs)


def dual_primal(
    idx: torch.Tensor,  # [n, L] int32
    coeff: torch.Tensor,  # [m, n, L] fp32 / bf16 / int8
    cost: torch.Tensor,  # [n, L] slab dtype
    mask: torch.Tensor,  # [n, L] slab dtype
    lam: torch.Tensor,  # [m * J] fp32
    gamma: float,
    *,
    num_destinations: int,
    radius: float = 1.0,
    inequality: bool = True,
    coeff_scale: Optional[torch.Tensor] = None,  # [m, 1, 1] f32 (int8 slabs)
    cost_scale: Optional[torch.Tensor] = None,  # [1, 1] f32 (int8 slabs)
) -> torch.Tensor:
    """The kernel on one bucket, planned for this call: x [n, L] in the
    storage dtype (fp32 for int8)."""
    quantized = check_slab("dual_primal", idx, coeff, cost, mask, lam, num_destinations,
                           coeff_scale, cost_scale)
    slab = Slab(idx, coeff, cost, mask, coeff_scale if quantized else None,
                cost_scale if quantized else None)
    plan = plan_slabs("dual_primal", [slab], num_destinations, radius=radius,
                      inequality=inequality)
    return primal_call(plan, lam, gamma)[0]
