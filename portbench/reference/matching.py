"""Plain float64 reference of the ridge-regularized matching LP's solve.

Written from the paper's equations (§3, Appendix B.2), in plain PyTorch over
the edge list, with no packing, kernel or fixed-point arithmetic:

    Jacobi scaling     A' = D A, b' = D b,  D_r = 1 / ||A_r||_2
    primal candidate   x*(lam) = Pi_C(-(A'^T lam + c) / gamma),
                       C = {x_i >= 0, sum_j x_ij <= 1} per source i
    gradient           grad g = A' x* - b'
    dual objective     g = c'x* + (gamma/2) ||x*||^2 + lam'(A' x* - b')
    step               eta = clamp(gamma / sigma_max(A')^2, 1e-5, 1e-1)
    AGD                Nesterov momentum beta = (t - 1) / (t + 2) on the
                       clamped dual, restarted (t = 1) when g falls, with a
                       fresh momentum per stage of the gamma schedule.

sigma_max^2 comes from 30 power-iteration steps on A' A'^T from the start
vector that the solver's `seed` names (standard normal from a CPU
`torch.Generator` seeded with it), so both sides take the same step.
Everything runs in float64 on the given device.  It imports nothing of the
program; the judge compares the program's outputs against it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["RefInstance", "EdgeState", "agd", "oracle", "power_iteration"]

_F = torch.float64


@dataclasses.dataclass
class RefInstance:
    """An edge list on the device, sorted by (source, destination), with its
    row-wise padded view for the per-source projection."""

    I: int
    J: int
    m: int
    src: torch.Tensor  # [nnz] int64
    dst: torch.Tensor  # [nnz] int64
    cost: torch.Tensor  # [nnz] f64, = -value
    coeff: torch.Tensor  # [m, nnz] f64
    rhs: torch.Tensor  # [m * J] f64
    slot: torch.Tensor  # [nnz] position of each edge in its source's row
    deg: torch.Tensor  # [I]
    width: int  # widest row
    rows: torch.Tensor  # [m * nnz] coupling row k*J + dst of each (family, edge)

    @classmethod
    def build(cls, I, J, m, src, dst, values, coeff, rhs, device) -> "RefInstance":
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(device)
        src, dst = t(src, torch.int64), t(dst, torch.int64)
        deg = torch.bincount(src, minlength=I)
        starts = torch.cumsum(deg, 0) - deg
        slot = torch.arange(src.numel(), device=device) - starts[src]
        rows = (torch.arange(m, device=device)[:, None] * J + dst[None]).reshape(-1)
        return cls(I, J, m, src, dst, -t(values, _F), t(coeff, _F).reshape(m, -1),
                   t(rhs, _F), slot, deg, int(deg.max()) if src.numel() else 1, rows)

    def row_sum(self, per_edge: torch.Tensor) -> torch.Tensor:
        """Sum [m, nnz] per-edge terms into the [m * J] coupling rows."""
        out = torch.zeros(self.m * self.J, dtype=_F, device=per_edge.device)
        return out.index_add_(0, self.rows, per_edge.reshape(-1))

    def scaled(self) -> tuple["RefInstance", torch.Tensor]:
        """The Jacobi-scaled instance and D."""
        norms = torch.sqrt(self.row_sum(self.coeff ** 2))
        d = torch.where(norms > 1e-30, 1.0 / norms.clamp_min(1e-30), 1.0)
        d2 = d.reshape(self.m, self.J)
        coeff = self.coeff * d2[:, self.dst]
        return dataclasses.replace(self, coeff=coeff, rhs=self.rhs * d), d

    def a_t(self, lam: torch.Tensor) -> torch.Tensor:
        """(A^T lam) on every edge."""
        lam2 = lam.reshape(self.m, self.J)
        return (self.coeff * lam2[:, self.dst]).sum(0)

    def project(self, v: torch.Tensor) -> torch.Tensor:
        """Each source's entries onto {x >= 0, sum x <= 1} (Duchi et al.)."""
        pad = torch.full((self.I, self.width), -1e300, dtype=_F, device=v.device)
        pad[self.src, self.slot] = v
        u = torch.sort(pad, dim=1, descending=True).values
        css = torch.cumsum(torch.where(u > -1e299, u, 0.0), dim=1)
        j = torch.arange(1, self.width + 1, dtype=_F, device=v.device)
        live = j[None] <= self.deg[:, None]
        rho = ((u * j > css - 1.0) & live).sum(1).clamp_min(1)
        theta = (css.gather(1, (rho - 1)[:, None])[:, 0] - 1.0) / rho
        pos = v.clamp_min(0.0)
        feasible = torch.zeros(self.I, dtype=_F, device=v.device).index_add_(
            0, self.src, pos) <= 1.0
        return torch.where(feasible[self.src], pos, (v - theta[self.src]).clamp_min(0.0))


def oracle(inst: RefInstance, lam: torch.Tensor, gamma: float):
    """(g, grad, x) at duals `lam`."""
    x = inst.project(-(inst.a_t(lam) + inst.cost) / gamma)
    grad = inst.row_sum(inst.coeff * x[None]) - inst.rhs
    g = (inst.cost * x).sum() + 0.5 * gamma * (x * x).sum() + (lam * grad).sum()
    return g, grad, x


def power_iteration(inst: RefInstance, seed: int, iters: int) -> torch.Tensor:
    """sigma_max(A)^2 by power iteration on A A^T."""
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.randn(inst.m * inst.J, generator=gen, dtype=torch.float32)
    u = u.to(device=inst.rhs.device, dtype=_F)
    norm = None
    for _ in range(iters):
        y = inst.a_t(u / torch.linalg.vector_norm(u))
        u = inst.row_sum(inst.coeff * y[None])
        norm = torch.linalg.vector_norm(u)
    return norm


def agd(inst: RefInstance, lam0: torch.Tensor, gammas, iters_per_stage: int,
        sigma_sq: torch.Tensor):
    """The gamma-continuation AGD from `lam0`; returns (lam, g, x) of the
    final oracle call at the last gamma."""
    lam = lam0.to(_F)
    for gamma in gammas:
        eta = torch.clamp(gamma / sigma_sq.clamp_min(1e-20), 1e-5, 1e-1)
        lam_prev, t, g_prev = lam, 1.0, -float("inf")
        for _ in range(iters_per_stage):
            beta = (t - 1.0) / (t + 2.0)
            mu = (lam + beta * (lam - lam_prev)).clamp_min(0.0)
            g, grad, _ = oracle(inst, mu, gamma)
            lam_prev, lam = lam, (mu + eta * grad).clamp_min(0.0)
            g = float(g)
            t = 1.0 if g < g_prev else t + 1.0
            g_prev = g
    g, _, x = oracle(inst, lam, gammas[-1])
    return lam, g, x


class EdgeState:
    """The edge list as deltas leave it: updates, deletes and inserts applied
    by key, each delta in turn (numpy, float64)."""

    def __init__(self, I, J, m, src, dst, values, coeff, rhs):
        self.I, self.J, self.m = I, J, m
        self.keys = np.asarray(src, np.int64) * J + np.asarray(dst, np.int64)
        self.values = np.asarray(values, np.float64).copy()
        self.coeff = np.asarray(coeff, np.float64).reshape(m, -1).copy()
        self.alive = np.ones(self.keys.size, bool)
        self.rhs = np.asarray(rhs, np.float64).copy()
        self.ins_keys, self.ins_values, self.ins_coeff = [], [], []

    def _find(self, keys: np.ndarray) -> np.ndarray:
        pos = np.minimum(np.searchsorted(self.keys, keys), self.keys.size - 1)
        if not np.all((self.keys[pos] == keys) & self.alive[pos]):
            raise KeyError("a delta names an edge that is not present")
        return pos

    def apply(self, d) -> None:
        J = self.J
        self.values[self._find(d.update_src * J + d.update_dst)] = d.update_values
        self.alive[self._find(d.delete_src * J + d.delete_dst)] = False
        self.ins_keys.append(d.insert_src * J + d.insert_dst)
        self.ins_values.append(np.asarray(d.insert_values, np.float64))
        self.ins_coeff.append(np.asarray(d.insert_coeff, np.float64).reshape(self.m, -1))
        self.rhs = np.asarray(d.rhs, np.float64).copy()

    def instance(self, device) -> RefInstance:
        """The current edge list, sorted by (source, destination)."""
        keys = np.concatenate([self.keys[self.alive], *self.ins_keys])
        values = np.concatenate([self.values[self.alive], *self.ins_values])
        coeff = np.concatenate([self.coeff[:, self.alive], *self.ins_coeff], axis=1)
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        if keys.size > 1 and np.any(keys[1:] == keys[:-1]):
            raise ValueError("a delta inserts an edge that is present")
        return RefInstance.build(self.I, self.J, self.m, keys // self.J, keys % self.J,
                                 values[order], coeff[:, order], self.rhs, device)
