"""ProjectionMap — blockwise projection operators (port of `repro.core.projections`).

Each operator projects every row of a padded slab `v [*, L]` (one row per
source) onto its feasible polytope, honouring a {0,1} mask of real entries.
Padded entries come out exactly zero and never influence the projection of
real entries.  These are the plain PyTorch versions: the dual-oracle kernel
(`repro_torch/kernels/csrc/dual_oracle.cu`) carries the same Duchi pipeline
in its `__device__` functions, and `UnitSimplexProjection(use_kernel=True)`
runs the simplex kernel (`csrc/simplex_proj.cu`).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

__all__ = [
    "ProjectionMap",
    "UnitSimplexProjection",
    "BoxProjection",
    "BoxCutProjection",
    "project_simplex",
    "project_box",
    "project_box_cut",
]

_NEG = -1.0e30  # finite stand-in for -inf; fp32-safe under cumsum

Radius = Union[float, torch.Tensor]


def _per_row(z: Radius) -> Radius:
    """A [n] radius tensor broadcasts per row; scalars pass through."""
    if isinstance(z, torch.Tensor) and z.ndim == 1:
        return z[:, None]
    return z


def _simplex_fwd(v, mask, z, inequality):
    """Sort -> cumsum -> cutoff rho -> threshold theta -> subtract-and-clamp,
    plus the inequality variant's early exit for already-feasible rows."""
    z = _per_row(z)
    L = v.shape[-1]
    vm = torch.where(mask > 0, v, _NEG)
    u = torch.sort(vm, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1)
    j = torch.arange(1, L + 1, dtype=v.dtype, device=v.device)
    cond = u * j > css - z  # u_j - (css_j - z)/j > 0
    rho = torch.clamp_min(cond.sum(dim=-1, keepdim=True).to(v.dtype), 1.0)
    css_rho = torch.where(j == rho, css, 0.0).sum(dim=-1, keepdim=True)
    theta = (css_rho - z) / rho
    w_eq = torch.clamp_min(vm - theta, 0.0) * mask
    if not inequality:
        return w_eq, None
    w0 = torch.clamp_min(v, 0.0) * mask
    feasible = w0.sum(dim=-1, keepdim=True) <= z
    return torch.where(feasible, w0, w_eq), feasible


class _ProjectSimplex(torch.autograd.Function):
    """Analytic derivative of the projection (reference: the custom JVP).

    On tight rows the Jacobian is P = diag(a) - a a^T / |a| over the active
    set a = {w > 0}; on feasible rows of the inequality variant it is the
    identity on the positive entries.  Both are symmetric, so the backward
    applies the same map to the incoming gradient.
    """

    @staticmethod
    def forward(ctx, v, mask, z, inequality):
        w, feasible = _simplex_fwd(v, mask, z, inequality)
        ctx.inequality = inequality
        ctx.save_for_backward(v, mask, w, feasible if inequality else w)
        return w

    @staticmethod
    def backward(ctx, gw):
        v, mask, w, feasible = ctx.saved_tensors
        act = (w > 0).to(v.dtype) * mask
        rho = torch.clamp_min(act.sum(dim=-1, keepdim=True), 1.0)
        davg = (act * gw).sum(dim=-1, keepdim=True) / rho
        grad = act * (gw - davg)
        if ctx.inequality:
            d_feas = (v > 0).to(v.dtype) * mask * gw
            grad = torch.where(feasible, d_feas, grad)
        return grad, None, None, None


def project_simplex(
    v: torch.Tensor,
    mask: torch.Tensor,
    radius: Radius = 1.0,
    *,
    inequality: bool = True,
) -> torch.Tensor:
    """Duchi et al. (2008) projection of each row onto the simplex.

    inequality=True  : project onto {w >= 0, sum(w) <= radius}
    inequality=False : project onto {w >= 0, sum(w) == radius}
    """
    return _ProjectSimplex.apply(v, mask, radius, inequality)


def project_box(
    v: torch.Tensor, mask: torch.Tensor, lo: Radius = 0.0, hi: Radius = 1.0
) -> torch.Tensor:
    """Elementwise projection onto [lo, hi] (padded entries -> 0)."""
    return torch.clamp(v, lo, hi) * mask


def project_box_cut(
    v: torch.Tensor,
    mask: torch.Tensor,
    lo: Radius = 0.0,
    hi: Radius = 1.0,
    radius: Radius = 1.0,
    *,
    iters: int = 64,
) -> torch.Tensor:
    """Projection onto {lo <= w <= hi} ∩ {sum(w) <= radius} ("box-cut").

    w(theta) = clip(v - theta, lo, hi) with theta >= 0 chosen by bisection so
    that sum(w(theta)) = radius when the plain box projection is infeasible.
    Requires lo >= 0 so that the sum is monotone in theta.
    """
    z = _per_row(radius)
    w_box = torch.clamp(v, lo, hi) * mask
    feasible = w_box.sum(dim=-1, keepdim=True) <= z

    def w_of(theta):
        return torch.clamp(v - theta, lo, hi) * mask

    # theta in [0, max(v - lo)]: at theta_hi every entry is at its lower bound.
    theta_hi = torch.clamp_min(
        torch.where(mask > 0, v, 0.0).amax(dim=-1, keepdim=True) - lo, 1.0
    )
    theta_lo = torch.zeros_like(theta_hi)
    for _ in range(iters):
        mid = 0.5 * (theta_lo + theta_hi)
        too_big = w_of(mid).sum(dim=-1, keepdim=True) > z
        theta_lo = torch.where(too_big, mid, theta_lo)
        theta_hi = torch.where(too_big, theta_hi, mid)
    w_cut = w_of(0.5 * (theta_lo + theta_hi))
    return torch.where(feasible, w_box, w_cut)


class ProjectionMap:
    """Blockwise projection operator Pi_C (paper Table 1).

    Subclasses implement `__call__(z_slab, mask) -> x_slab` for one padded
    bucket slab.
    """

    def __call__(self, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UnitSimplexProjection(ProjectionMap):
    radius: float = 1.0
    inequality: bool = True
    # route through the fused simplex kernel (paper §4.3); on CPU tensors
    # that is its plain version, `kernels.ref.simplex_ref`
    use_kernel: bool = False

    def __call__(self, v, mask):
        if self.use_kernel:
            from repro_torch.kernels import ops as kops

            return kops.fused_project_simplex(
                v, mask, radius=self.radius, inequality=self.inequality
            )
        return project_simplex(
            v, mask, radius=self.radius, inequality=self.inequality
        )


@dataclasses.dataclass(frozen=True)
class BoxProjection(ProjectionMap):
    lo: float = 0.0
    hi: float = 1.0

    def __call__(self, v, mask):
        return project_box(v, mask, self.lo, self.hi)


@dataclasses.dataclass(frozen=True)
class BoxCutProjection(ProjectionMap):
    lo: float = 0.0
    hi: float = 1.0
    radius: float = 1.0
    iters: int = 64

    def __call__(self, v, mask):
        return project_box_cut(
            v, mask, self.lo, self.hi, self.radius, iters=self.iters
        )
