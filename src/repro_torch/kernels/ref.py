"""Plain PyTorch versions of the kernels (port of `repro.kernels.ref`).

`simplex_ref` is the multi-op Duchi pipeline (sort -> cumsum -> cutoff ->
threshold -> subtract-and-clamp); `dual_primal_ref` is the unfused primal
step x = Pi_simplex( -(A^T lam + c) * (1/gamma) ) for one bucket slab;
`dual_oracle_ref` is the whole one-pass oracle (primal slab + this bucket's
A x histogram + the c'x / ||x||^2 partials).  They are the plain versions
of the three CUDA kernels: the path every CPU tensor takes and what each
kernel is held against on the card.

Narrow slabs follow the kernel's contract: widened to fp32 on load (int8
times its per-bucket scales), every reduction in fp32, and x written back in
the storage dtype for float storage (fp32 for int8).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.objective import _acc32, binned_segment_sum, gather_at_lam, inv_gamma
from repro_torch.core.projections import project_simplex

__all__ = ["simplex_ref", "dual_primal_ref", "dual_oracle_ref"]


def _dequant(coeff, cost, mask, coeff_scale, cost_scale):
    coeff, cost, mask = _acc32(coeff), _acc32(cost), _acc32(mask)
    if coeff_scale is not None:
        coeff = coeff * coeff_scale.reshape(-1, 1, 1)
    if cost_scale is not None:
        cost = cost * cost_scale.reshape(1, 1)
    return coeff, cost, mask


def simplex_ref(
    v: torch.Tensor,
    mask: torch.Tensor,
    radius: float = 1.0,
    *,
    inequality: bool = True,
) -> torch.Tensor:
    """Reference masked Duchi projection (identical semantics to the kernel):
    narrow rows are projected in fp32 and returned in v's dtype."""
    x = project_simplex(_acc32(v), _acc32(mask), radius, inequality=inequality)
    return x if x.dtype == v.dtype else x.to(v.dtype)


def dual_primal_ref(
    idx: torch.Tensor,  # [n, L] int32 destination ids
    coeff: torch.Tensor,  # [m, n, L] (slab dtype)
    cost: torch.Tensor,  # [n, L] (slab dtype)
    mask: torch.Tensor,  # [n, L] (slab dtype)
    lam: torch.Tensor,  # [m * J] fp32
    gamma,
    J: int,
    radius: float = 1.0,
    *,
    inequality: bool = True,
    coeff_scale: Optional[torch.Tensor] = None,  # [m, 1, 1] f32 (int8 slabs)
    cost_scale: Optional[torch.Tensor] = None,  # [1, 1] f32 (int8 slabs)
) -> torch.Tensor:
    """Unfused primal step for one bucket: gather, axpy, scale, project."""
    out_dtype = cost.dtype if coeff_scale is None else torch.float32
    coeff, cost, mask = _dequant(coeff, cost, mask, coeff_scale, cost_scale)
    atl = gather_at_lam(coeff, idx, lam.reshape(coeff.shape[0], J))
    z = -(atl + cost) * inv_gamma(gamma)
    x = project_simplex(z, mask, radius, inequality=inequality)
    return x if x.dtype == out_dtype else x.to(out_dtype)


def dual_oracle_ref(
    idx: torch.Tensor,
    coeff: torch.Tensor,
    cost: torch.Tensor,
    mask: torch.Tensor,
    lam: torch.Tensor,
    gamma,
    J: int,
    radius: float = 1.0,
    *,
    inequality: bool = True,
    coeff_scale: Optional[torch.Tensor] = None,
    cost_scale: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass oracle for one bucket: `(x, hist, lin, sq)` where

        x    [n, L]  = Pi_simplex( -(A^T lam + c) * (1/gamma) )
        hist [m, J]  = this bucket's contribution to A x
        lin  scalar  = c'x        (this bucket's part)
        sq   scalar  = ||x||^2    (this bucket's part)

    hist/lin/sq reduce the fp32 primal slab; the projection multiplies by
    `mask`, so x is exact-zero on padded slots and needs no re-masking.
    """
    out_dtype = cost.dtype if coeff_scale is None else torch.float32
    coeff, cost, mask = _dequant(coeff, cost, mask, coeff_scale, cost_scale)
    x = dual_primal_ref(
        idx, coeff, cost, mask, lam, gamma, J, radius, inequality=inequality
    )
    hist = binned_segment_sum(idx, coeff * x[None], J)
    lin = torch.dot(cost.reshape(-1), x.reshape(-1))
    sq = torch.dot(x.reshape(-1), x.reshape(-1))
    x_out = x if x.dtype == out_dtype else x.to(out_dtype)
    return x_out, hist, lin, sq
