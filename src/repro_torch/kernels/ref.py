"""Plain PyTorch versions of the kernels (port of `repro.kernels.ref`).

`simplex_ref` is the multi-op Duchi pipeline (sort -> cumsum -> cutoff ->
threshold -> subtract-and-clamp); `dual_primal_ref` is the unfused primal
step x = Pi_simplex( -(A^T lam + c) * (1/gamma) ) for one bucket slab;
`dual_oracle_ref` is the one-pass oracle of one bucket (primal slab + this
bucket's A x histogram + the c'x / ||x||^2 partials) and
`dual_oracle_call_ref` the whole oracle call over every bucket;
`dual_oracle_batched_ref` is that call over a stack of same-shape instances
(the tenant axis), lane by lane, and `dual_primal_rows_ref` the primal step
restricted to requested rows (the serving query).  They are the plain
versions of the three CUDA kernels: the path every CPU tensor takes and
what each kernel is held against on the card.

`fixed_point_hist` is for tests only: A x summed as the oracle kernel sums
it, in int64 fixed point, which is exact, so the kernel's A x equals it bit
for bit on the card.

Narrow slabs follow the kernel's contract: widened to fp32 on load (int8
times its per-bucket scales), every reduction in fp32, and x written back in
the storage dtype for float storage (fp32 for int8).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.objective import _acc32, binned_segment_sum, gather_at_lam, inv_gamma
from repro_torch.core.projections import project_simplex

__all__ = [
    "dual_oracle_batched_ref",
    "dual_oracle_call_ref",
    "dual_primal_rows_ref",
    "dual_oracle_ref",
    "dual_primal_ref",
    "fixed_point_hist",
    "simplex_ref",
]


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


def dual_oracle_call_ref(
    buckets,  # Buckets (or kernels.dual_oracle.Slab) sharing m and dtype
    lam: torch.Tensor,
    gamma,
    J: int,
    radius: float = 1.0,
    *,
    inequality: bool = True,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole oracle call: `(x_slabs, ax [m*J], lin, sq)`, each bucket's
    `dual_oracle_ref` summed in bucket order starting from zeros."""
    ax2 = torch.zeros((buckets[0].coeff.shape[0], J), dtype=torch.float32,
                      device=lam.device)
    lin = sq = 0.0
    x_slabs = []
    for b in buckets:
        x, hist, b_lin, b_sq = dual_oracle_ref(
            b.idx, b.coeff, b.cost, b.mask, lam, gamma, J, radius,
            inequality=inequality, coeff_scale=b.coeff_scale, cost_scale=b.cost_scale,
        )
        x_slabs.append(x)
        ax2 = ax2 + hist
        lin = lin + b_lin
        sq = sq + b_sq
    return tuple(x_slabs), ax2.reshape(-1), lin, sq


class LaneSlab(NamedTuple):
    """Lane b of a stacked slab ([B, ...] tensors)."""

    idx: torch.Tensor
    coeff: torch.Tensor
    cost: torch.Tensor
    mask: torch.Tensor
    coeff_scale: Optional[torch.Tensor]
    cost_scale: Optional[torch.Tensor]


def lane_slab(s, b: int) -> LaneSlab:
    """Lane `b` of a stacked bucket or slab: views of its [B, ...] tensors."""
    opt = lambda t: None if t is None else t[b]
    return LaneSlab(s.idx[b], s.coeff[b], s.cost[b], s.mask[b], opt(s.coeff_scale),
                    opt(s.cost_scale))


def dual_oracle_batched_ref(
    buckets,  # stacked buckets: [B, ...] tensors of one shape
    lam: torch.Tensor,  # [B, m * J]
    gamma,  # a float shared by the lanes, or a [B] tensor: gamma_b per lane
    J: int,
    radius: float = 1.0,
    *,
    inequality: bool = True,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole oracle call of every lane: `(x_slabs [B, n, L] each, ax
    [B, m*J], lin [B], sq [B])`, lane b being `dual_oracle_call_ref` of
    lane b's slabs and duals at its gamma (`gamma[b]` for a tensor, whose
    1/gamma_b rounds as `inv_gamma(gamma_b)`)."""
    gammas = (gamma.detach().cpu().tolist() if isinstance(gamma, torch.Tensor)
              else [gamma] * lam.shape[0])
    per = [dual_oracle_call_ref([lane_slab(b, i) for b in buckets], lam[i], gammas[i], J,
                                radius, inequality=inequality)
           for i in range(lam.shape[0])]
    xs = tuple(torch.stack([p[0][k] for p in per]) for k in range(len(buckets)))
    return (xs, torch.stack([p[1] for p in per]), torch.stack([p[2] for p in per]),
            torch.stack([p[3] for p in per]))


def dual_primal_rows_ref(
    buckets,
    requests: Sequence[tuple[int, np.ndarray]],  # (bucket, rows int64 [q])
    lam: torch.Tensor,  # [m * J] fp32
    gamma,
    J: int,
    radius: float = 1.0,
    *,
    inequality: bool = True,
) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The primal step of the requested rows of each bucket: per request
    `(x [q, L] fp32, mask [q, L] fp32, idx [q, L] int32)`, `dual_primal_ref`
    of the gathered rows widened to fp32 (so bf16 slabs give the fp32 x
    before the storage cast)."""
    out = []
    for t, rows in requests:
        b = buckets[int(t)]
        r = torch.as_tensor(np.asarray(rows, np.int64), device=b.idx.device)
        coeff, cost, mask = _dequant(b.coeff[:, r], b.cost[r], b.mask[r], b.coeff_scale,
                                     b.cost_scale)
        idx = b.idx[r]
        x = dual_primal_ref(idx, coeff, cost, mask, lam, gamma, J, radius,
                            inequality=inequality)
        out.append((x, mask, idx))
    return out


def fixed_point_hist(
    buckets,
    lam: torch.Tensor,
    gamma,
    J: int,
    shift: int,
    radius: float = 1.0,
    *,
    inequality: bool = True,
) -> torch.Tensor:
    """A x [m*J] as the oracle kernel sums it (test-only): each contribution
    coeff_k * x in fp32, times 2^shift, rounded half to even into an int64,
    summed exactly per bin (`index_add_`), then converted to fp32 once and
    scaled by 2^-shift.  x is the plain version's fp32 x."""
    m = buckets[0].coeff.shape[0]
    acc = torch.zeros(m * J, dtype=torch.int64, device=lam.device)
    offs = torch.arange(m, device=lam.device, dtype=torch.int64)[:, None] * J
    for b in buckets:
        coeff, cost, mask = _dequant(b.coeff, b.cost, b.mask, b.coeff_scale, b.cost_scale)
        x = dual_primal_ref(b.idx, coeff, cost, mask, lam, gamma, J, radius,
                            inequality=inequality)
        contrib = (coeff * x[None]).double() * 2.0 ** shift  # exact in fp64
        q = torch.round(contrib).to(torch.int64)  # half to even
        bins = (b.idx.reshape(1, -1).long() + offs).reshape(-1)
        acc.index_add_(0, bins, q.reshape(-1))
    return acc.to(torch.float32) * 2.0 ** -shift
