"""Plain float64 reference of the matching solve, laid out for the paper's
per-card size (~250M edges): the equations of `reference/matching.py`,
written again over two orders of the same edges so that a card makes one
oracle call in tens of milliseconds.

- **Grouped by degree.**  The sources of each degree d form one [d, n_d]
  block of the grouped order, a source's edges in edge order down its
  column, so the projection sorts each block at its own width and sums
  along the block's short axis (`matching.py` pads every source to the
  widest row and sorts that).
- **Sorted by coupling row.**  A x sums each row k*J + j by one segmented
  reduction over the contributions put in row order, in place of an
  `index_add_` of every (family, edge).

    Jacobi scaling     A' = D A, b' = D b,  D_r = 1 / ||A_r||_2
    primal candidate   x*(lam) = Pi_C(-(A'^T lam + c) / gamma),
                       C = {x_i >= 0, sum_j x_ij <= 1} per source i
    gradient           grad g = A' x* - b'
    dual objective     g = c'x* + (gamma/2) ||x*||^2 + lam'(A' x* - b')
    step, AGD and the power iteration as in `matching.py`.

Everything runs in float64 on the given device; the per-degree blocks are
the blocks the projection works in.  Some sums are taken in other orders
than in `matching.py` (dot products, segmented sums), so the two agree to
rounding, about 1e-15 relative.  The instance also keeps the edge-order
arrays (`src`, `dst`, `cost`, `coeff`, `rhs`) that `judge.slab_numbers`
reads.  It imports nothing of the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["GroupedInstance", "agd", "oracle", "power_iteration"]

_F = torch.float64


@dataclasses.dataclass
class GroupedInstance:
    """An edge list on the device, sorted by (source, destination), with its
    degree-grouped and row-sorted orders."""

    I: int
    J: int
    m: int
    src: torch.Tensor  # [nnz] int64, edge order
    dst: torch.Tensor  # [nnz] int64, edge order
    cost: torch.Tensor  # [nnz] f64, = -value, edge order
    coeff: torch.Tensor  # [m, nnz] f64, edge order
    rhs: torch.Tensor  # [m * J] f64
    perm: torch.Tensor  # [nnz] edge of each grouped position
    blocks: list  # (degree d, first grouped position, sources n_d), ascending d;
    # a block is [d, n_d]: slot k of its r-th source at position k * n_d + r
    dst_g: torch.Tensor  # [nnz] int32 destination, grouped order
    cost_g: torch.Tensor  # [nnz] f64, grouped order
    coeff_g: torch.Tensor  # [m, nnz] f64, grouped order
    row_order: torch.Tensor  # [m * nnz] int32 grouped (family, position) sorted by row
    row_offsets: torch.Tensor  # [m * J + 1] where each row starts in row_order

    @classmethod
    def build(cls, I, J, m, src, dst, values, coeff, rhs, device) -> "GroupedInstance":
        t = lambda a, dt: torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)
        src, dst = t(src, torch.int64), t(dst, torch.int64)
        cost, coeff = -t(values, _F), t(coeff, _F).reshape(m, -1)
        deg = torch.bincount(src, minlength=I)
        starts = torch.cumsum(deg, 0) - deg
        # sources by degree, ascending within one; block d holds slot k of
        # its r-th source at k * n_d + r
        by_degree = torch.argsort(deg, stable=True)
        per_degree = torch.bincount(deg).tolist()  # sources of each degree
        blocks, parts, pos, at = [], [], per_degree[0], 0
        for d, n in enumerate(per_degree):
            if d and n:
                first = starts[by_degree[pos:pos + n]]
                parts.append((first[None, :] + torch.arange(d, device=device)[:, None]).reshape(-1))
                blocks.append((d, at, n))
                pos, at = pos + n, at + d * n
        perm = torch.cat(parts)
        del parts
        dst_g = dst[perm]
        rows = (torch.arange(m, device=device)[:, None] * J + dst_g[None]).reshape(-1)
        dst_g = dst_g.to(torch.int32)
        counts = torch.bincount(rows, minlength=m * J)
        return cls(I, J, m, src, dst, cost, coeff, t(rhs, _F), perm, blocks, dst_g,
                   cost[perm], coeff[:, perm], torch.argsort(rows, stable=True).to(torch.int32),
                   torch.cat([counts.new_zeros(1), counts.cumsum(0)]))

    def row_sum(self, per_edge: torch.Tensor) -> torch.Tensor:
        """Sum [m, nnz] per-edge terms (grouped order) into the [m * J]
        coupling rows."""
        ordered = torch.index_select(per_edge.reshape(-1), 0, self.row_order)
        return torch.segment_reduce(ordered, "sum", offsets=self.row_offsets, unsafe=True)

    def scaled(self) -> tuple["GroupedInstance", torch.Tensor]:
        """The Jacobi-scaled instance and D."""
        norms = torch.sqrt(self.row_sum(self.coeff_g ** 2))
        d = torch.where(norms > 1e-30, 1.0 / norms.clamp_min(1e-30), 1.0)
        d2 = d.reshape(self.m, self.J)
        return dataclasses.replace(self, coeff=self.coeff * d2[:, self.dst],
                                   coeff_g=self.coeff_g * d2[:, self.dst_g.long()],
                                   rhs=self.rhs * d), d

    def a_t(self, lam: torch.Tensor, plus: torch.Tensor | None = None) -> torch.Tensor:
        """(A^T lam) on every edge, grouped order; `plus` ([nnz]) added."""
        lam2 = lam.reshape(self.m, self.J)
        at = lambda k: torch.index_select(lam2[k], 0, self.dst_g)  # noqa: E731
        out = self.coeff_g[0] * at(0) if plus is None else torch.addcmul(plus, self.coeff_g[0], at(0))
        for k in range(1, self.m):
            out.addcmul_(self.coeff_g[k], at(k))
        return out

    def project(self, v: torch.Tensor) -> torch.Tensor:
        """Each source's entries (grouped order) onto {x >= 0, sum x <= 1},
        one degree block [d, n_d] at a time, its sources along the columns:
        x = (v - theta)+, with theta = 0 where the positive part sums to at
        most 1, and otherwise the theta with sum x = 1 (Duchi et al., as
        `matching.py` computes it), found from the source's entries sorted
        at the block's width: theta = max_k (sum of the k largest - 1) / k."""
        x = torch.empty_like(v)
        for d, p, n in self.blocks:
            w = v[p:p + d * n].view(d, n)
            over = torch.nonzero(w.clamp_min(0.0).sum(0) > 1.0).reshape(-1)
            theta = torch.zeros(n, dtype=_F, device=v.device)
            if over.numel():
                prefix = torch.sort(w[:, over], dim=0, descending=True).values.cumsum(0)
                k = torch.arange(1, d + 1, dtype=_F, device=v.device)[:, None]
                theta[over] = ((prefix - 1.0) / k).amax(0)
            torch.sub(w, theta, out=x[p:p + d * n].view(d, n)).clamp_min_(0.0)
        return x

    def in_edge_order(self, x_g: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x_g)
        out[self.perm] = x_g
        return out


def _oracle(inst: GroupedInstance, lam: torch.Tensor, gamma: float):
    """(g, grad, x in grouped order) at duals `lam`."""
    x = inst.project(inst.a_t(lam, plus=inst.cost_g).div_(-gamma))
    grad = inst.row_sum(inst.coeff_g * x[None]) - inst.rhs
    g = torch.dot(inst.cost_g, x) + 0.5 * gamma * torch.dot(x, x) + torch.dot(lam, grad)
    return g, grad, x


def oracle(inst: GroupedInstance, lam: torch.Tensor, gamma: float):
    """(g, grad, x) at duals `lam`, x in edge order."""
    g, grad, x = _oracle(inst, lam, gamma)
    return g, grad, inst.in_edge_order(x)


def power_iteration(inst: GroupedInstance, seed: int, iters: int) -> torch.Tensor:
    """sigma_max(A)^2 by power iteration on A A^T."""
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.randn(inst.m * inst.J, generator=gen, dtype=torch.float32)
    u = u.to(device=inst.rhs.device, dtype=_F)
    norm = None
    for _ in range(iters):
        y = inst.a_t(u / torch.linalg.vector_norm(u))
        u = inst.row_sum(inst.coeff_g * y[None])
        norm = torch.linalg.vector_norm(u)
    return norm


def agd(inst: GroupedInstance, lam0: torch.Tensor, gammas, iters_per_stage: int,
        sigma_sq: torch.Tensor):
    """The gamma-continuation AGD from `lam0`; returns (lam, g, x) of the
    final oracle call at the last gamma, x in edge order."""
    lam = lam0.to(_F)
    for gamma in gammas:
        eta = torch.clamp(gamma / sigma_sq.clamp_min(1e-20), 1e-5, 1e-1)
        lam_prev, t, g_prev = lam, 1.0, -float("inf")
        for _ in range(iters_per_stage):
            beta = (t - 1.0) / (t + 2.0)
            mu = (lam + beta * (lam - lam_prev)).clamp_min(0.0)
            g, grad, _ = _oracle(inst, mu, gamma)
            lam_prev, lam = lam, (mu + eta * grad).clamp_min(0.0)
            g = float(g)
            t = 1.0 if g < g_prev else t + 1.0
            g_prev = g
    g, _, x = oracle(inst, lam, gammas[-1])
    return lam, g, x
