"""Dispatch of the three kernels (port of `repro.kernels.ops`).

  fused_dual_oracle      one-pass oracle      kernel dual_oracle.dual_oracle
  fused_dual_primal      the primal step      kernel dual_primal.dual_primal
  fused_project_simplex  simplex projection   kernel simplex_proj.simplex_proj

Each routes by where the tensors live:
  * CPU tensors take the plain version (`ref.dual_oracle_ref`,
    `ref.dual_primal_ref`, `ref.simplex_ref`);
  * CUDA tensors take the hand-written kernel, which raises on anything it
    does not take (dtype, shape, capacity, a failed build or launch);
    nothing falls back to the plain version;
  * any other device raises.
One shape rule comes first, as in the reference (the paper's multi-launch
policy, §4.3): a width that is not a power of two or exceeds
MAX_FUSED_LENGTH = 8192 goes to the plain version on any device, and
`width_routed` counts those calls.  `bucketize` only makes power-of-two
widths, so the count stays 0 unless some source has more than 8192 edges.

The kernels need no row padding: they mask the ragged tail themselves.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dual_oracle as kdo
from repro_torch.kernels import dual_primal as kdp
from repro_torch.kernels import ref as kref
from repro_torch.kernels import simplex_proj as ksp
from repro_torch.kernels.dual_oracle import MAX_FUSED_LENGTH

__all__ = [
    "MAX_FUSED_LENGTH",
    "fused_dual_oracle",
    "fused_dual_primal",
    "fused_project_simplex",
    "oracle_hist_partial_bytes",
    "oracle_slab_slot_bytes",
    "width_routed",
]

width_routed = 0  # calls sent to a plain version by the width rule

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _use_kernel(t: torch.Tensor) -> bool:
    """Whether a call on slab `t` [..., L] goes to its kernel (CUDA) or to
    its plain version (CPU, or a width the kernels do not take, counted in
    `width_routed`); any other device raises."""
    global width_routed
    L = t.shape[-1]
    if not _is_pow2(L) or L > MAX_FUSED_LENGTH:
        width_routed += 1
        return False
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel path for device {t.device}")
    return True


def oracle_slab_slot_bytes(num_families: int, slab_dtype="float32") -> int:
    """HBM bytes per slab slot of one fused-oracle call: the idx read (int32),
    coeff/cost/mask reads at the storage width, and the x write (storage
    width for float slabs, fp32 for int8)."""
    name = str(slab_dtype).removeprefix("torch.")
    size = _ITEMSIZE[name]
    return 4 + (num_families + 2) * size + (4 if name == "int8" else size)


def oracle_hist_partial_bytes(
    n_rows: int, length: int, num_families: int, num_destinations: int,
    num_sms: int,
) -> int:
    """Per-call partial-histogram HBM traffic of one bucket on the port's
    persistent grid: one [m, J] fp32 write per block plus its read by the
    tree-sum."""
    plan = kdo.plan_launch(n_rows, length, num_families, num_destinations, num_sms)
    return 2 * 4 * plan.grid * num_families * num_destinations


def fused_dual_oracle(
    idx: torch.Tensor,  # [n, L] int32
    coeff: torch.Tensor,  # [m, n, L] slab dtype
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass fused dual oracle for one bucket: `(x, hist, lin, sq)`.

    hist [m, J] = this bucket's A x contribution, lin = c'x, sq = ||x||^2,
    all fp32; x is in the storage dtype (fp32 for int8).  On the kernel path
    the per-block partials are tree-summed here.
    """
    args = (idx, coeff, cost, mask, lam, gamma)
    kw = dict(radius=radius, inequality=inequality,
              coeff_scale=coeff_scale, cost_scale=cost_scale)
    if not _use_kernel(cost):
        return kref.dual_oracle_ref(*args, num_destinations, **kw)
    x, hist_p, scal_p = kdo.dual_oracle(
        *args, num_destinations=num_destinations, **kw
    )
    lin, sq = scal_p.sum(dim=0)
    return x, hist_p.sum(dim=0), lin, sq


def fused_dual_primal(
    idx: torch.Tensor,  # [n, L] int32
    coeff: torch.Tensor,  # [m, n, L] slab dtype
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
    """Whole fused primal step x = Pi( -(A^T lam + c)/gamma ) for one
    bucket; x is in the storage dtype (fp32 for int8)."""
    args = (idx, coeff, cost, mask, lam, gamma)
    kw = dict(radius=radius, inequality=inequality,
              coeff_scale=coeff_scale, cost_scale=cost_scale)
    if not _use_kernel(cost):
        return kref.dual_primal_ref(*args, num_destinations, **kw)
    return kdp.dual_primal(*args, num_destinations=num_destinations, **kw)


def fused_project_simplex(
    v: torch.Tensor,  # [n, L] fp32 / bf16
    mask: torch.Tensor,  # [n, L]
    *,
    radius: float = 1.0,
    inequality: bool = True,
) -> torch.Tensor:
    """Fused Duchi simplex projection of slab rows (paper §4.3), in v's
    dtype."""
    if not _use_kernel(v):
        return kref.simplex_ref(v, mask, radius, inequality=inequality)
    return ksp.simplex_proj(v, mask, radius, inequality=inequality)
