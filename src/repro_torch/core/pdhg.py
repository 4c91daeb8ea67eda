"""Restarted PDHG baseline (cuPDLP / D-PDLP family) on an unstructured COO
matrix (port of `repro.core.pdhg`) — the paper's §7.2 comparator.

The LP is treated as *unstructured*: one generic sparse K stacks the coupling
rows AND the per-source simplex rows (the reformulation a generic LP solver
is forced into, which is the structural disadvantage the paper exploits).

    min c'x   s.t.  K x <= q,  0 <= x <= u
    x+ = clip(x - tau (c + K'y), 0, u)
    y+ = max(0, y + sigma (K (2 x+ - x) - q))        tau sigma ||K||^2 < 1

Termination mirrors D-PDLP: relative primal residual, relative dual residual,
and relative gap all below `tol` (paper uses 1e-4).

The reference's K and K' are scatter-adds (`.at[].add`).  On the card a
scatter-add of floats uses atomics, whose order changes from run to run.
Here `COOLP` sorts its entries once by row and once by column, and K x / K'y
sum each row's (column's) products in int64 fixed point: the products,
rounded to fp32 as the reference's are, are scaled by a power of two chosen
on the device from a bound on the call's sum, rounded to int64, prefix-summed
(exact, so in any order) and differenced at the segment ends (`_fixed_sum`).
The same bits in every run, on the CPU and the card, with no host wait, and
each sum rounded once to fp32.  (`torch.segment_reduce` over the same
offsets is deterministic too, but its one block per segment is slow for the
8M two-entry columns of K'y at the paper's size.)
The reference's `lax.while_loop` is a Python loop with one host read every
`check_every` iterations (the convergence test); everything else stays on
the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.maximizer import StageStats
from repro_torch.core.objective import start_vector
from repro_torch.device import resolve_device
from repro_torch.instances.generator import EdgeListInstance

__all__ = ["COOLP", "PDHGConfig", "PDHGResult", "from_edge_list", "solve_pdhg"]


# Sums are scaled so that every partial sum's magnitude stays below 2^61
# (one bit of slack under int64 for the products' and the scaling's
# roundings); 2^shift stays a normal fp64 number.
FIXED_POINT_BITS = 61
MAX_SHIFT = 100


class _Order(NamedTuple):
    """The entries of K sorted by one axis (stably: each segment keeps the
    entries' order): where each segment ends, the other axis's index and
    the value of every entry in that order, and sum |vals|."""

    ends: torch.Tensor  # [segments] int64: one past each segment's last entry
    other: torch.Tensor  # [nnz] int64: column (row order) or row (column order)
    vals: torch.Tensor  # [nnz]
    abs_sum: float  # sum |vals|, the bound of a call's sum per unit max|v|


def _order(key: torch.Tensor, other: torch.Tensor, vals: torch.Tensor, n: int) -> _Order:
    perm = torch.argsort(key, stable=True)
    ends = torch.bincount(key, minlength=n).cumsum(0)
    return _Order(ends, other.long()[perm], vals[perm], float(vals.abs().double().sum()))


def _fixed_sum(order: _Order, v: torch.Tensor) -> torch.Tensor:
    """Per segment, sum of vals * v[other], exact in int64 fixed point.

    The scale 2^shift is the largest with sum|vals| * max|v| * 2^shift <=
    2^FIXED_POINT_BITS, computed on the device; each fp32 product times it
    is exact in fp64 and is rounded half to even to an int64.  The prefix
    sum of those integers is exact, so each segment's total (a difference
    of two prefixes) is the same whatever order the device adds in."""
    p = (order.vals * v[order.other]).double()
    bound = torch.clamp_min(order.abs_sum * v.abs().max().double(), 2.0 ** -MAX_SHIFT)
    shift = torch.clamp(torch.floor(FIXED_POINT_BITS - torch.log2(bound)), -MAX_SHIFT, MAX_SHIFT)
    scale = torch.exp2(shift)
    prefix = torch.cumsum(torch.round(p * scale).long(), 0)
    at_ends = torch.cat([prefix.new_zeros(1), prefix])[order.ends]
    seg = torch.diff(at_ends, prepend=at_ends.new_zeros(1))
    return (seg.double() / scale).to(v.dtype)


@dataclasses.dataclass
class COOLP:
    """Unstructured LP in COO form: min c'x s.t. Kx <= q, 0 <= x <= u."""

    rows: torch.Tensor  # [nnz] int32
    cols: torch.Tensor  # [nnz] int32
    vals: torch.Tensor  # [nnz] f32
    c: torch.Tensor  # [n]
    q: torch.Tensor  # [R]
    u: torch.Tensor  # [n] upper bounds
    num_rows: int
    num_cols: int
    # the entries by row (for K) and by column (for K'), sorted once
    _by_row: _Order = dataclasses.field(init=False, repr=False, compare=False)
    _by_col: _Order = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        rows, cols = self.rows.long(), self.cols.long()
        self._by_row = _order(rows, cols, self.vals, self.num_rows)
        self._by_col = _order(cols, rows, self.vals, self.num_cols)

    def K(self, x: torch.Tensor) -> torch.Tensor:
        return _fixed_sum(self._by_row, x)

    def KT(self, y: torch.Tensor) -> torch.Tensor:
        return _fixed_sum(self._by_col, y)

    @property
    def nbytes(self) -> int:
        """Device bytes of the matrix: the COO arrays, both sorted copies with
        their segment ends, and c, q, u."""
        ts = [self.rows, self.cols, self.vals, self.c, self.q, self.u,
              *self._by_row[:3], *self._by_col[:3]]
        return int(sum(t.numel() * t.element_size() for t in ts))


def from_edge_list(
    inst: EdgeListInstance, dtype=torch.float32, device="cuda"
) -> COOLP:
    """Stack coupling rows and per-source simplex rows into one generic K.

    Variables are the eligible edges (one x_e per (i,j) in E).  This is the
    'treat the system as unstructured' formulation that D-PDLP sees.
    """
    dev = resolve_device(device)
    spec = inst.spec
    I, J, m = spec.num_sources, spec.num_destinations, spec.num_families
    nnz = inst.nnz
    e = np.arange(nnz, dtype=np.int64)
    rows = [k * J + inst.dst for k in range(m)] + [m * J + inst.src]
    cols = [e] * (m + 1)
    vals = [inst.coeff[k] for k in range(m)] + [np.ones(nnz)]
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(dev)
    return COOLP(
        rows=as_t(np.concatenate(rows).astype(np.int32), torch.int32),
        cols=as_t(np.concatenate(cols).astype(np.int32), torch.int32),
        vals=as_t(np.concatenate(vals), dtype),
        c=as_t(inst.cost, dtype),
        q=as_t(np.concatenate([inst.rhs, np.ones(I)]), dtype),
        u=torch.ones((nnz,), dtype=dtype, device=dev),
        num_rows=m * J + I,
        num_cols=nnz,
    )


@dataclasses.dataclass(frozen=True)
class PDHGConfig:
    max_iters: int = 20000
    tol: float = 1e-4  # D-PDLP's relative tolerance
    restart_every: int = 200  # restart to the ergodic average (PDLP-style)
    check_every: int = 50
    power_iters: int = 50
    step_ratio: float = 1.0  # tau/sigma balance
    seed: int = 0


class PDHGResult(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    iters: int
    primal_obj: torch.Tensor
    dual_obj: torch.Tensor
    rel_gap: torch.Tensor
    primal_res: torch.Tensor
    dual_res: torch.Tensor
    converged: torch.Tensor
    # Convergence-telemetry parity with core.maximizer.SolveResult: `stats` is
    # a 1-tuple of StageStats at check_every resolution (g=primal objective,
    # grad_norm=dual residual, max_violation=primal residual; entries past the
    # last check backfilled with the final residuals), `iters_used` a 1-tuple
    # of the iterations actually executed.  Both feed
    # telemetry.ConvergenceTrace.from_result(engine="pdhg",
    # trace_stride=check_every) unchanged.
    stats: tuple = ()
    iters_used: Optional[tuple[int, ...]] = None


def _residuals(lp: COOLP, x, y):
    kx = lp.K(x)
    primal_res = torch.linalg.vector_norm(torch.clamp_min(kx - lp.q, 0.0)) / (
        1.0 + torch.linalg.vector_norm(lp.q)
    )
    r = lp.c + lp.KT(y)  # reduced costs
    # dual objective for 0 <= x <= u: -q'y + sum_i min(0, r_i) * u_i
    dual_obj = -torch.dot(lp.q, y) + torch.dot(torch.clamp_max(r, 0.0), lp.u)
    primal_obj = torch.dot(lp.c, x)
    # dual residual: violation of r >= 0 where x can still increase is captured
    # by the gap; use projected-gradient norm as the dual residual proxy
    dual_res = torch.linalg.vector_norm(
        x - torch.minimum(torch.clamp_min(x - r, 0.0), lp.u)
    ) / (1.0 + torch.linalg.vector_norm(lp.c))
    rel_gap = torch.abs(primal_obj - dual_obj) / (
        1.0 + torch.abs(primal_obj) + torch.abs(dual_obj)
    )
    return primal_obj, dual_obj, rel_gap, primal_res, dual_res


def _done(gap, pr, dr, tol: float) -> torch.Tensor:
    return (gap < tol) & (pr < tol) & (dr < tol)


def solve_pdhg(lp: COOLP, config: PDHGConfig = PDHGConfig()) -> PDHGResult:
    """Solve the COO LP on its device.  The only host reads are one per
    convergence check (every `check_every` iterations); `iters_used` is the
    host's own count."""
    cfg = config
    dev = lp.c.device
    n, R = lp.num_cols, lp.num_rows
    n_checks = max(1, -(-cfg.max_iters // cfg.check_every))

    # ||K||_2 by power iteration
    v = start_vector(n, cfg.seed, dev)
    for _ in range(cfg.power_iters):
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-20)
        v = lp.KT(lp.K(v))
    sigma_max = torch.sqrt(torch.linalg.vector_norm(v))
    tau = cfg.step_ratio / torch.clamp_min(sigma_max, 1e-20) * 0.9
    sig = 1.0 / (cfg.step_ratio * torch.clamp_min(sigma_max, 1e-20)) * 0.9

    x = torch.zeros((n,), dtype=torch.float32, device=dev)
    y = torch.zeros((R,), dtype=torch.float32, device=dev)
    x_sum, y_sum = torch.zeros_like(x), torch.zeros_like(y)
    k = 0
    bufs: list[tuple] = []  # (primal_obj, dual_res, primal_res) per check
    it = 0
    while it < cfg.max_iters:
        x1 = torch.minimum(torch.clamp_min(x - tau * (lp.c + lp.KT(y)), 0.0), lp.u)
        y1 = torch.clamp_min(y + sig * (lp.K(2.0 * x1 - x) - lp.q), 0.0)
        x_sum, y_sum = x_sum + x1, y_sum + y1
        k += 1
        it += 1
        # PDLP-style fixed-frequency restart to the ergodic average
        if it % cfg.restart_every == 0:
            x, y = x_sum / k, y_sum / k
            x_sum, y_sum = torch.zeros_like(x_sum), torch.zeros_like(y_sum)
            k = 0
        else:
            x, y = x1, y1
        if it % cfg.check_every == 0:
            po, _, gap, pr, dr = _residuals(lp, x, y)
            bufs.append((po, dr, pr))
            if bool(_done(gap, pr, dr, cfg.tol)):
                break
    po, do_, gap, pr, dr = _residuals(lp, x, y)
    # backfill check slots the loop never reached with the final residuals
    fill = [(po, dr, pr)] * (n_checks - len(bufs))
    bg, bdr, bpr = (torch.stack(list(t)) for t in zip(*(bufs + fill)))
    return PDHGResult(
        x=x, y=y, iters=it, primal_obj=po, dual_obj=do_,
        rel_gap=gap, primal_res=pr, dual_res=dr,
        converged=_done(gap, pr, dr, cfg.tol),
        stats=(StageStats(g=bg, grad_norm=bdr, max_violation=bpr),),
        iters_used=(it,),
    )
