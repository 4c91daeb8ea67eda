"""Structured PDHG engine on the bucketed-ELL form (port of
`repro.engines.pdhg`).

  minimize   c'x   s.t.  A x <= b,   x in C  (per-source simplex rows)

with the primal-dual hybrid gradient iteration

  x+ = Proj_C(x - tau * (c + A'y))
  y+ = max(0, y + sig * (A (2 x+ - x) - b)),      tau * sig * ||A||^2 < 1.

  * **Fused prox step.**  `x - tau*(c + A'y) = -(A'y + (c - x/tau)) / (1/tau)`,
    so the prox step is the one-pass dual oracle with `cost_eff = c - x/tau`
    (`kernels.ops.fused_pdhg_step_call`): on the card one oracle launch and
    one finalize per iteration take the step of every bucket and emit
    `A x+` (exact int64 fixed point).  The `cost_eff` buffers and the
    oracle's plan over them are made once per solve (`ops.plan_pdhg_step`).
  * **Restarts.**  `none | ergodic | adaptive | halpern`: ergodic resets to
    the running average on a fixed cadence; Halpern anchors
    (`x <- (t+1)/(t+2) x+ + 1/(t+2) x0`) and re-anchors on that cadence;
    adaptive compares the current iterate and the window average by merit
    `max(rel_primal, rel_dual, rel_gap)` at every check and restarts to the
    better one when it beats the merit at the last restart by a fixed factor.
  * **Dense small-shard path.**  A small shard (`PDHGEngineConfig.dense`)
    merges its buckets into one padded slab, projects with the sort-free
    `project_simplex_cmp` and applies A as one matrix product against a
    one-hot destination matrix built once per solve (a plain product, as in
    the reference, outside any kernel).
  * **Termination.**  Relative residuals checked every `cfg.check_every`
    iterations through the Maximizer's chunked early stop
    (`maximizer._chunked_early_scan`), with the all-processes-agree vote in
    the sharded solve.

The reference's `lax.scan` is a Python loop here.  The fixed-cadence
restart decisions are host integers; the adaptive decision reads two merits
from the device once per check, where the early stop waits anyway.  tau and
sig are fp32 values read once per solve (one host sync).

The batched solve (`pdhg_raw_solve_batched`, the port of the reference's
`jax.vmap(pdhg_raw_solve)` over a stack of same-shape instances) runs one
iteration loop over every lane: each lane has its own tau and sig (from its
own sigma_max(A)^2), restart state and stop vote; the fused prox step is ONE
batched oracle call with a 1/gamma per lane (`ops.fused_pdhg_step_batched_call`),
the dense path one batched product, the unfused path one pass over the
stacked slabs (`core.batched`).  The host reads every lane's merits and
residuals in one sync per check.  A lane that has converged keeps its state
and traces frozen while the others run on, as JAX's batched `while_loop`
does, and its iteration count is its own.

Warm starts: `lam0` is the previous cadence's duals and the primal starts at
`x0 = Proj_C(-(A'lam0 + c) / gamma_floor)`.  PDHG solves the unsmoothed LP:
`ridge_weight` never enters the iteration.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.batched import (
    BatchedObjective,
    gather_lanes,
    lane_offsets,
    normalize_lanes,
    project_lanes,
)
from repro_torch.core.maximizer import (
    MaximizerConfig,
    SolveResult,
    StageStats,
    _chunked_early_scan,
)
from repro_torch.core.objective import (
    MatchingObjective,
    gather_at_lam,
    normalize_rows_traced,
)
from repro_torch.core.projections import UnitSimplexProjection, project_simplex_cmp
from repro_torch.engines.base import RawSolve
from repro_torch.instances.buckets import Bucket, BucketedInstance
from repro_torch.kernels import ops as kops

__all__ = [
    "PDHGCore",
    "PDHGEngine",
    "PDHG_ENGINE",
    "PDHGEngineConfig",
    "RESTART_SCHEMES",
    "PDHGBatchedCore",
    "pdhg_raw_solve",
    "pdhg_raw_solve_batched",
    "solve_pdhg_sharded",
]

RESTART_SCHEMES = ("none", "ergodic", "adaptive", "halpern")


@dataclasses.dataclass(frozen=True)
class PDHGEngineConfig:
    """PDHG-specific knobs; budgets and tolerances come from
    `MaximizerConfig` (total iteration budget = `cfg.total_iter_budget`,
    check cadence = `cfg.check_every`, tolerance = `cfg.tol_grad` falling
    back to `cfg.tol_viol`)."""

    restart: str = "adaptive"
    restart_every: int = 100  # ergodic/halpern cadence (iterations)
    step_ratio: float = 1.0  # omega = tau/sig balance
    step_margin: float = 0.9  # tau*sig*||A||^2 = margin^2 < 1
    restart_threshold: float = 0.8  # adaptive sufficient-decay factor
    # dense small-shard path: merged buckets + sort-free projection + one-hot
    # A-apply.  "auto" takes it when the one-hot matrix stays under
    # `dense_max_cells` entries and padding does not blow the slab up.
    dense: str = "auto"
    dense_max_cells: int = 1 << 22

    def __post_init__(self):
        if self.restart not in RESTART_SCHEMES:
            raise ValueError(f"restart={self.restart!r} not in {RESTART_SCHEMES}")
        if not (0.0 < self.step_margin < 1.0):
            raise ValueError("step_margin must lie in (0, 1)")
        if self.dense not in ("auto", "on", "off"):
            raise ValueError('dense must be one of "auto" | "on" | "off"')


def _uniform_simplex(obj: MatchingObjective) -> UnitSimplexProjection:
    """PDHG's dual objective needs a closed-form min over C; simplex only.

    `min_{x in C} (c + A'y)'x` decomposes per source row as
    `radius * min(0, min_j r_j)` (inequality simplex) or `radius * min_j r_j`
    (equality); other feasible sets would need their own support function,
    so they are refused.
    """
    projs = {obj._proj(i) for i in range(len(obj.instance.buckets))}
    if len(projs) != 1 or not isinstance(next(iter(projs)), UnitSimplexProjection):
        raise NotImplementedError(
            f"PDHG engine supports a uniform simplex feasible set; got {projs}"
        )
    return next(iter(projs))


def _use_dense(buckets, num_destinations: int, pcfg: PDHGEngineConfig) -> bool:
    """Shape-only decision for the dense small-shard path."""
    if pcfg.dense == "off" or not buckets:
        return False
    if pcfg.dense == "on":
        return True
    l_max = max(int(b.idx.shape[-1]) for b in buckets)
    rows = sum(int(b.idx.shape[0]) for b in buckets)
    slots = sum(int(b.idx.shape[0]) * int(b.idx.shape[-1]) for b in buckets)
    merged = rows * l_max
    # the one-hot apply matrix is [J, merged]; padding every row to the
    # longest bucket must also not blow the working set up
    return merged * num_destinations <= pcfg.dense_max_cells and merged <= 4 * max(slots, 1)


def _merge_buckets(buckets, costs, row_axis: int = 0) -> Bucket:
    """Per-length bucket slabs as one [rows, L_max] pseudo-bucket; pad
    entries carry mask 0 and coeff 0, like the pad slots of every bucket.
    Stacked slabs ([B, ...], the batched solve) merge along `row_axis` 1."""
    l_max = max(int(b.idx.shape[-1]) for b in buckets)

    def padded(a):
        return F.pad(a, (0, l_max - a.shape[-1]))

    return Bucket(
        idx=torch.cat([padded(b.idx) for b in buckets], dim=row_axis).to(torch.int32),
        coeff=torch.cat([padded(b.coeff) for b in buckets], dim=row_axis + 1),
        cost=torch.cat([padded(c) for c in costs], dim=row_axis).float(),
        mask=torch.cat([padded(b.mask) for b in buckets], dim=row_axis).float(),
        length=l_max,
    )


def _dense_onehot(mb: Bucket, num_destinations: int) -> torch.Tensor:
    """[J, slots] one-hot destination matrix: `A x` is one matrix product.
    Pad slots point at bin 0 with weight 0."""
    flat_idx = mb.idx.reshape(-1).long()
    onehot = torch.zeros((num_destinations, flat_idx.shape[0]), dtype=torch.float32,
                         device=flat_idx.device)
    onehot[flat_idx, torch.arange(flat_idx.shape[0], device=flat_idx.device)] = (
        mb.mask.reshape(-1).float())
    return onehot


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _f32(v) -> np.float32:
    return np.float32(v)


class _State(NamedTuple):
    x: tuple  # primal slabs (one merged slab on the dense path)
    y: torch.Tensor  # duals [m*J]
    ax: Optional[torch.Tensor]  # A x (None on the dense path)
    it: int  # iterations counted for the fixed-cadence schemes
    restarts: int
    extra: tuple  # the restart scheme's state


class PDHGCore:
    """One PDHG solve: set-up at construction, `run()` the whole solve.

    `reduce_sum` sums partials across the processes of a sharded solve
    (identity when None); `stop_reduce` makes the stop vote collective.
    `initial_state()` and `one_iter()` are the solve's own pieces, for
    driving a window of iterations outside `run()` (profiling)."""

    def __init__(
        self,
        obj: MatchingObjective,
        lam0: torch.Tensor,
        cfg: MaximizerConfig,
        pcfg: PDHGEngineConfig,
        *,
        fused_oracle: bool,
        sigma_sq,
        reduce_sum: Optional[Callable] = None,
        stop_reduce: Optional[Callable] = None,
    ):
        inst = obj.instance
        self.obj, self.lam0, self.cfg, self.pcfg = obj, lam0, cfg, pcfg
        self.m, self.J = m, J = inst.num_families, inst.num_destinations
        proj = _uniform_simplex(obj)
        self.radius, self.inequality = proj.radius, proj.inequality
        self.reduce_sum = reduce_sum or (lambda v: v)
        self.stop_reduce = stop_reduce

        buckets = obj._buckets  # fp32 compute views (dequantized once per solve)
        costs = tuple(obj._scaled_cost(b) for b in buckets)
        self.rhs = inst.rhs.float()
        self.rhs_norm = torch.linalg.vector_norm(self.rhs)
        c_sq_local = sum(_vdot(c * b.mask, c * b.mask) for b, c in zip(buckets, costs))
        self.c_norm = torch.sqrt(self.reduce_sum(c_sq_local.reshape(1))[0])

        # the steps as fp32 values, read once (one host sync per solve)
        self.sigma_sq = _f32(float(sigma_sq))
        sigma = np.sqrt(np.maximum(self.sigma_sq, _f32(1e-20)))
        self.tau = float(_f32(pcfg.step_margin * pcfg.step_ratio) / sigma)
        self.sig = float(_f32(pcfg.step_margin / pcfg.step_ratio) / sigma)

        self.dense = _use_dense(buckets, J, pcfg)
        self.step = None
        if self.dense:
            self.split_shapes = [(int(b.idx.shape[0]), int(b.idx.shape[-1])) for b in buckets]
            self.mb = _merge_buckets(buckets, costs)
            self.onehot = _dense_onehot(self.mb, J)
            buckets, costs = (self.mb,), (self.mb.cost,)
            radius, inequality = self.radius, self.inequality
            self.projs = [lambda z, mask: project_simplex_cmp(z, mask, radius,
                                                              inequality=inequality)]
        else:
            self.projs = [obj._proj(i) for i in range(len(buckets))]
            if fused_oracle:
                self.step = kops.plan_pdhg_step(
                    buckets, costs, num_destinations=J, radius=self.radius,
                    inequality=self.inequality)
        self.buckets, self.costs = buckets, costs

    # ---- A x on the dense path ---------------------------------------------

    def _dense_apply_a(self, xs: torch.Tensor) -> torch.Tensor:
        contrib = (self.mb.coeff * xs).reshape(self.m, -1)
        return (contrib @ self.onehot.T).reshape(-1)

    # ---- one primal prox step + the A x+ apply -------------------------------

    def primal_step(self, x, y):
        """(x+, A x+), or on the dense path (x+, A(2 x+ - x)): A is linear,
        so the dual step's extrapolated apply is one product and the dense
        iteration carries no A x."""
        tau = self.tau
        if self.dense:
            mb = self.mb
            z = x[0] - tau * (gather_at_lam(mb.coeff, mb.idx, y.reshape(self.m, self.J))
                              + mb.cost)
            xn = self.projs[0](z, mb.mask)
            return (xn,), self.reduce_sum(self._dense_apply_a(2.0 * xn - x[0]))
        if self.step is not None:
            xs, ax = kops.fused_pdhg_step_call(self.step, x, y, tau)
            return xs, self.reduce_sum(ax)
        y2 = y.reshape(self.m, self.J)
        new = tuple(
            self.projs[i](xs - tau * (gather_at_lam(b.coeff, b.idx, y2) + c), b.mask)
            for i, (b, c, xs) in enumerate(zip(self.buckets, self.costs, x))
        )
        return new, self.reduce_sum(self.obj.apply_A(new))

    # ---- relative residuals ----------------------------------------------------

    def residuals(self, x, y, ax):
        """(primal_obj, dual_obj, rel_primal, rel_dual, rel_gap)."""
        viol = torch.clamp_min(ax - self.rhs, 0.0)
        pr = torch.linalg.vector_norm(viol) / (1.0 + self.rhs_norm)
        y2 = y.reshape(self.m, self.J)
        pobj_loc = dr_loc = dual_loc = torch.zeros((), dtype=torch.float32, device=y.device)
        for i, (b, c, xs) in enumerate(zip(self.buckets, self.costs, x)):
            r = gather_at_lam(b.coeff, b.idx, y2) + c
            pg = xs - self.projs[i](xs - r, b.mask)
            pobj_loc = pobj_loc + _vdot(c * b.mask, xs)
            dr_loc = dr_loc + _vdot(pg, pg)
            rmin = torch.where(b.mask > 0, r, torch.inf).amin(dim=-1)
            has = (b.mask > 0).any(dim=-1)
            contrib = self.radius * (torch.clamp_max(rmin, 0.0) if self.inequality else rmin)
            dual_loc = dual_loc + torch.where(has, contrib, 0.0).sum()
        sums = self.reduce_sum(torch.stack([pobj_loc, dual_loc, dr_loc]))
        pobj = sums[0]
        dobj = sums[1] - _vdot(self.rhs, y)
        dr = torch.sqrt(torch.clamp_min(sums[2], 0.0)) / (1.0 + self.c_norm)
        gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
        return pobj, dobj, pr, dr, gap

    # ---- the iteration with the selected restart scheme ------------------------

    def one_iter(self, state: _State) -> _State:
        x, y, ax, it, restarts, extra = state
        scheme, every, dense = self.pcfg.restart, int(self.pcfg.restart_every), self.dense
        xn, axn = self.primal_step(x, y)
        if dense:
            # primal_step returned A(2 x+ - x) directly; nothing is carried
            yn = torch.clamp_min(y + self.sig * (axn - self.rhs), 0.0)
            axn = None
        else:
            yn = torch.clamp_min(y + self.sig * (2.0 * axn - ax - self.rhs), 0.0)
        it1 = it + 1 if scheme in ("ergodic", "halpern") else it
        if scheme == "none":
            return _State(xn, yn, axn, it1, restarts, extra)
        if scheme in ("ergodic", "adaptive"):
            xs_sum, y_sum, ax_sum, win = extra[:4]
            xs_sum = tuple(s + v for s, v in zip(xs_sum, xn))
            y_sum, win = y_sum + yn, win + 1
            ax_sum = None if dense else ax_sum + axn
            if scheme == "ergodic" and it1 % every == 0:
                wf = float(max(win, 1))
                xn = tuple(s / wf for s in xs_sum)
                yn = y_sum / wf
                if not dense:
                    axn = ax_sum / wf
                xs_sum = tuple(torch.zeros_like(s) for s in xs_sum)
                y_sum = torch.zeros_like(y_sum)
                ax_sum = None if dense else torch.zeros_like(ax_sum)
                win, restarts = 0, restarts + 1
            return _State(xn, yn, axn, it1, restarts, (xs_sum, y_sum, ax_sum, win) + extra[4:])
        # halpern: blend toward the anchor, re-anchor on a fixed cadence
        xa, ya, axa, t = extra
        w = (t + _f32(1.0)) / (t + _f32(2.0))
        w, w1 = float(w), float(_f32(1.0) - w)
        xn = tuple(w * v + w1 * a for v, a in zip(xn, xa))
        yn = w * yn + w1 * ya
        if not dense:
            axn = w * axn + w1 * axa
        if it1 % every == 0:
            return _State(xn, yn, axn, it1, restarts + 1, (xn, yn, axn, _f32(0.0)))
        return _State(xn, yn, axn, it1, restarts, (xa, ya, axa, t + _f32(1.0)))

    def _check(self, state: _State):
        """`check_every` iterations, then the residuals (and the adaptive
        restart): `(state, (primal_obj, rel_dual, rel_primal, rel_gap))`."""
        for _ in range(self.inner):
            state = self.one_iter(state)
        x, y, ax, it, restarts, extra = state
        dense = self.dense
        if dense:
            # the ax-free dense carry recomputes A x once per check
            ax = self.reduce_sum(self._dense_apply_a(x[0]))
        if self.pcfg.restart == "adaptive":
            # sufficient-decay restart: compare the current iterate against
            # the window average by merit, adopt the better one when it beats
            # the merit at the last restart by `restart_threshold`
            xs_sum, y_sum, ax_sum, win, merit_last = extra
            wf = float(max(win, 1))
            x_avg = tuple(s / wf for s in xs_sum)
            y_avg = y_sum / wf
            ax_avg = (self.reduce_sum(self._dense_apply_a(x_avg[0])) if dense
                      else ax_sum / wf)
            res_c = self.residuals(x, y, ax)
            res_a = self.residuals(x_avg, y_avg, ax_avg)
            merit = lambda r: torch.maximum(r[4], torch.maximum(r[2], r[3]))  # noqa: E731
            merit_c, merit_a = (_f32(v) for v in
                                torch.stack([merit(res_c), merit(res_a)]).tolist())
            merit_cand = min(merit_a, merit_c)
            do = bool(merit_cand <= _f32(self.pcfg.restart_threshold) * merit_last)
            if do and merit_a < merit_c:
                x, y, ax, res = x_avg, y_avg, ax_avg, res_a
            else:
                res = res_c
            if do:
                xs_sum = tuple(torch.zeros_like(s) for s in xs_sum)
                y_sum = torch.zeros_like(y_sum)
                ax_sum = None if dense else torch.zeros_like(ax_sum)
                win, merit_last, restarts = 0, merit_cand, restarts + 1
            extra = (xs_sum, y_sum, ax_sum, win, merit_last)
        else:
            res = self.residuals(x, y, ax)
        po, _, pr, dr, gap = res
        traces = tuple(v.float() for v in (po, dr, pr, gap))
        return _State(x, y, None if dense else ax, it, restarts, extra), traces

    def _stop(self, traces) -> torch.Tensor:
        cfg = self.cfg
        tol = cfg.tol_grad if cfg.tol_grad is not None else cfg.tol_viol
        _, dr, pr, gap = traces
        if tol is None:
            return torch.zeros((), dtype=torch.bool, device=pr.device)
        t = float(_f32(tol))
        return (pr[-1] <= t) & (dr[-1] <= t) & (gap[-1] <= t)

    @property
    def inner(self) -> int:
        total = int(self.cfg.total_iter_budget)
        return max(1, min(int(self.cfg.check_every), total))

    def initial_state(self) -> _State:
        """The warm-start point: y0 = lam0, x0 = Proj_C(-(A'y0 + c) / gamma_floor)."""
        y0 = self.lam0.float()
        x0 = tuple(xs.float() for xs in self.obj.primal_candidate(y0, self.cfg.gammas[-1]))
        if self.dense:
            l_max = self.mb.idx.shape[-1]
            x0 = (torch.cat([F.pad(xs, (0, l_max - xs.shape[-1])) for xs in x0]),)
            ax0 = None  # ax-free carry; recomputed from x at check boundaries
        else:
            ax0 = self.reduce_sum(self.obj.apply_A(x0)).float()
        scheme = self.pcfg.restart
        if scheme in ("ergodic", "adaptive"):
            extra = (tuple(torch.zeros_like(xs) for xs in x0), torch.zeros_like(y0),
                     None if self.dense else torch.zeros_like(ax0), 0)
            if scheme == "adaptive":
                extra = extra + (_f32(np.inf),)
        elif scheme == "halpern":
            extra = (x0, y0, ax0, _f32(0.0))
        else:
            extra = ()
        return _State(x0, y0, ax0, 0, 0, extra)

    def run(self) -> RawSolve:
        total = int(self.cfg.total_iter_budget)
        n_checks = -(-total // self.inner)
        final, bufs, checks_used = _chunked_early_scan(
            self._check, self.initial_state(), n_checks,
            check_every=1,  # `_check` already runs `inner` iterations per call
            stop_predicate=self._stop, stop_reduce=self.stop_reduce,
        )
        x, y, ax = final.x, final.y, final.ax
        if self.dense:
            ax = self.reduce_sum(self._dense_apply_a(x[0]))
        pobj = self.residuals(x, y, ax)[0]
        if self.dense:
            # per-bucket slabs again; pad columns past each bucket's length are 0
            merged, parts, off = x[0], [], 0
            for rows_i, len_i in self.split_shapes:
                parts.append(merged[off:off + rows_i, :len_i])
                off += rows_i
            x = tuple(parts)
        return RawSolve(
            lam=y,
            x_slabs=x,
            g=pobj,
            stats=(StageStats(g=bufs[0], grad_norm=bufs[1], max_violation=bufs[2]),),
            sigma_sq=torch.tensor(self.sigma_sq, dtype=torch.float32),
            etas=torch.tensor([self.tau], dtype=torch.float32),
            iters=torch.tensor([checks_used * self.inner], dtype=torch.int32),
            restarts=torch.tensor(final.restarts, dtype=torch.int32),
        )


# ---------------------------------------------------------------------------
# The batched solve: every lane of a stack of same-shape instances at once.
# ---------------------------------------------------------------------------


def _lane_select(flags, device):
    """Host flags, one per lane, as what `_pick` takes: True or False when
    every flag agrees, else a [B] bool tensor on `device`, copied without
    waiting for the device (from pinned memory on the card)."""
    if all(flags) or not any(flags):
        return bool(flags[0])
    sel = torch.tensor(flags, dtype=torch.bool)
    if device.type == "cuda":
        sel = sel.pin_memory()
    return sel.to(device, non_blocking=True)


def _pick(sel, a, b):
    """Lane b of `a` where the lane is selected, else of `b`
    (`_lane_select`); without a copy when every lane agrees."""
    if a is None or sel is True:
        return a
    if sel is False:
        return b
    return torch.where(sel.view(-1, *[1] * (a.dim() - 1)), a, b)


def _keep(flags, sel, new, old):
    """The state `new` in the lanes of `flags` (`sel` on the device) and
    `old` elsewhere: tensors lane by lane, per-lane host lists entry by
    entry; shared host scalars (the iteration counter, Halpern's t) are
    the running lanes' (`new`)."""
    if isinstance(new, torch.Tensor):
        return _pick(sel, new, old)
    if isinstance(new, list):
        return [n if f else o for f, n, o in zip(flags, new, old)]
    if isinstance(new, tuple):
        parts = [_keep(flags, sel, n, o) for n, o in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    return new


def _lane_div(s: torch.Tensor, wfs) -> torch.Tensor:
    """s / wf_b in every lane, each lane divided by its Python float as the
    solo solve divides (PyTorch's CUDA division by a Python scalar is a
    product with its fp32 reciprocal, by a tensor a true division)."""
    if len(set(wfs)) == 1:
        return s / wfs[0]
    return torch.stack([s[b] / wf for b, wf in enumerate(wfs)])


class _BState(NamedTuple):
    x: tuple  # [B, n, L] primal slabs (one merged [B, rows, L_max] on the dense path)
    y: torch.Tensor  # [B, m*J]
    ax: Optional[torch.Tensor]  # [B, m*J] (None on the dense path)
    it: int  # iterations of the running lanes, for the fixed-cadence schemes
    restarts: list  # per lane
    extra: tuple  # the restart scheme's state; per-lane host values as lists


class PDHGBatchedCore:
    """The PDHG solve of every lane of a stacked instance (`core.batched`):
    `PDHGCore`'s iteration with a lane axis, the semantics of the
    reference's `jax.vmap(pdhg_raw_solve)`.  Every lane is its solo solve
    (`PDHGCore`) bit for bit on the bucketed paths: the slab work runs over
    all lanes at once in the solo arithmetic, each lane's scalars (norms,
    dots, merits) by the solo ops on its own slices, and each lane's
    decisions on the host as the solo solve takes them.  Single process."""

    def __init__(
        self,
        obj: BatchedObjective,
        lam0: torch.Tensor,  # [B, m*J]
        cfg: MaximizerConfig,
        pcfg: PDHGEngineConfig,
        *,
        fused_oracle: bool,
        sigma_sq,  # [B]
    ):
        inst = obj.instance
        self.obj, self.lam0, self.cfg, self.pcfg = obj, lam0, cfg, pcfg
        self.B = B = obj.num_lanes
        self.m, self.J = m, J = inst.num_families, inst.num_destinations
        proj = _uniform_simplex(obj.lanes[0])
        self.radius, self.inequality = proj.radius, proj.inequality

        buckets = obj._buckets  # stacked fp32 compute views
        costs = tuple(obj._scaled_cost(b) for b in buckets)
        self.rhs = inst.rhs.float()
        cm = [c * b.mask for b, c in zip(buckets, costs)]
        self.rhs_norm = [torch.linalg.vector_norm(self.rhs[b]) for b in range(B)]
        self.c_norm = [torch.sqrt(sum(_vdot(t[b], t[b]) for t in cm)) for b in range(B)]

        # each lane's steps as fp32 values, read once (one host sync per solve)
        self.sigma_sq = [_f32(v) for v in torch.as_tensor(sigma_sq).float().tolist()]
        self.taus, self.sigs = [], []
        for s2 in self.sigma_sq:
            sigma = np.sqrt(np.maximum(s2, _f32(1e-20)))
            self.taus.append(float(_f32(pcfg.step_margin * pcfg.step_ratio) / sigma))
            self.sigs.append(float(_f32(pcfg.step_margin / pcfg.step_ratio) / sigma))
        dev = self.rhs.device
        self.tau_t = torch.tensor(self.taus, dtype=torch.float32, device=dev).view(B, 1, 1)
        self.sig_t = torch.tensor(self.sigs, dtype=torch.float32, device=dev).view(B, 1)

        self.dense = _use_dense(obj.lanes[0]._buckets, J, pcfg)
        self.step = None
        if self.dense:
            self.split_shapes = [(int(b.idx.shape[1]), int(b.idx.shape[-1])) for b in buckets]
            self.mb = _merge_buckets(buckets, costs, row_axis=1)
            self.onehot = torch.stack([
                _dense_onehot(SimpleNamespace(idx=self.mb.idx[b], mask=self.mb.mask[b]), J)
                for b in range(B)])
            buckets, costs = (self.mb,), (self.mb.cost,)
            radius, inequality = self.radius, self.inequality
            self.projs = [lambda z, mask: project_simplex_cmp(z, mask, radius,
                                                              inequality=inequality)]
            self.offsets = (lane_offsets(self.mb.idx, m * J),)
        else:
            self.projs = [obj._proj(i) for i in range(len(buckets))]
            self.offsets = obj.lane_indices()
            if fused_oracle:
                self.step = kops.plan_pdhg_step_batched(
                    buckets, costs, self.taus, num_destinations=J, radius=self.radius,
                    inequality=self.inequality)
        self.buckets, self.costs = buckets, costs
        self.cost_masked = tuple(c * b.mask for b, c in zip(buckets, costs))

    def _gather(self, i: int, b: Bucket, y: torch.Tensor) -> torch.Tensor:
        return gather_lanes(b.coeff, self.offsets[i], y, self.J)

    def _dense_apply_a(self, xs: torch.Tensor) -> torch.Tensor:
        contrib = (self.mb.coeff * xs[:, None]).reshape(self.B, self.m, -1)
        return (contrib @ self.onehot.transpose(1, 2)).reshape(self.B, -1)

    def primal_step(self, x, y):
        """(x+, A x+) of every lane, or on the dense path (x+, A(2 x+ - x))."""
        if self.dense:
            mb = self.mb
            z = x[0] - self.tau_t * (self._gather(0, mb, y) + mb.cost)
            xn = self.projs[0](z, mb.mask)
            return (xn,), self._dense_apply_a(2.0 * xn - x[0])
        if self.step is not None:
            return kops.fused_pdhg_step_batched_call(self.step, x, y)
        new = tuple(
            project_lanes(self.projs[i], xs - self.tau_t * (self._gather(i, b, y) + c), b.mask)
            for i, (b, c, xs) in enumerate(zip(self.buckets, self.costs, x)))
        return new, self.obj.apply_A(new)

    def residuals(self, x, y, ax):
        """(primal_obj, dual_obj, rel_primal, rel_dual, rel_gap), each [B]:
        the slab work over every lane at once, each lane's sums by the solo
        ops on its slices."""
        viol = torch.clamp_min(ax - self.rhs, 0.0)
        pgs, duals = [], []
        for i, (b, c, xs) in enumerate(zip(self.buckets, self.costs, x)):
            r = self._gather(i, b, y) + c
            pgs.append(xs - project_lanes(self.projs[i], xs - r, b.mask))
            rmin = torch.where(b.mask > 0, r, torch.inf).amin(dim=-1)
            has = (b.mask > 0).any(dim=-1)
            contrib = self.radius * (torch.clamp_max(rmin, 0.0) if self.inequality else rmin)
            duals.append(torch.where(has, contrib, 0.0))
        out = []
        for ln in range(self.B):
            zero = torch.zeros((), dtype=torch.float32, device=y.device)
            pobj_loc = dr_loc = dual_loc = zero
            for cm, xs, pg, d in zip(self.cost_masked, x, pgs, duals):
                pobj_loc = pobj_loc + _vdot(cm[ln], xs[ln])
                dr_loc = dr_loc + _vdot(pg[ln], pg[ln])
                dual_loc = dual_loc + d[ln].sum()
            pr = torch.linalg.vector_norm(viol[ln]) / (1.0 + self.rhs_norm[ln])
            pobj = pobj_loc
            dobj = dual_loc - _vdot(self.rhs[ln], y[ln])
            dr = torch.sqrt(torch.clamp_min(dr_loc, 0.0)) / (1.0 + self.c_norm[ln])
            gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
            out.append((pobj, dobj, pr, dr, gap))
        return tuple(torch.stack(v) for v in zip(*out))

    def one_iter(self, state: _BState) -> _BState:
        x, y, ax, it, restarts, extra = state
        scheme, every, dense = self.pcfg.restart, int(self.pcfg.restart_every), self.dense
        xn, axn = self.primal_step(x, y)
        if dense:
            yn = torch.clamp_min(y + self.sig_t * (axn - self.rhs), 0.0)
            axn = None
        else:
            yn = torch.clamp_min(y + self.sig_t * (2.0 * axn - ax - self.rhs), 0.0)
        it1 = it + 1 if scheme in ("ergodic", "halpern") else it
        if scheme == "none":
            return _BState(xn, yn, axn, it1, restarts, extra)
        if scheme in ("ergodic", "adaptive"):
            xs_sum, y_sum, ax_sum, win = extra[:4]
            xs_sum = tuple(s + v for s, v in zip(xs_sum, xn))
            y_sum, win = y_sum + yn, [w + 1 for w in win]
            ax_sum = None if dense else ax_sum + axn
            if scheme == "ergodic" and it1 % every == 0:
                wfs = [float(max(w, 1)) for w in win]
                xn = tuple(_lane_div(s, wfs) for s in xs_sum)
                yn = _lane_div(y_sum, wfs)
                if not dense:
                    axn = _lane_div(ax_sum, wfs)
                xs_sum = tuple(torch.zeros_like(s) for s in xs_sum)
                y_sum = torch.zeros_like(y_sum)
                ax_sum = None if dense else torch.zeros_like(ax_sum)
                win, restarts = [0] * self.B, [r + 1 for r in restarts]
            return _BState(xn, yn, axn, it1, restarts, (xs_sum, y_sum, ax_sum, win) + extra[4:])
        xa, ya, axa, t = extra
        w = (t + _f32(1.0)) / (t + _f32(2.0))
        w, w1 = float(w), float(_f32(1.0) - w)
        xn = tuple(w * v + w1 * a for v, a in zip(xn, xa))
        yn = w * yn + w1 * ya
        if not dense:
            axn = w * axn + w1 * axa
        if it1 % every == 0:
            return _BState(xn, yn, axn, it1, [r + 1 for r in restarts],
                           (xn, yn, axn, _f32(0.0)))
        return _BState(xn, yn, axn, it1, restarts, (xa, ya, axa, t + _f32(1.0)))

    def _check(self, state: _BState):
        """`check_every` iterations, then the residuals and the adaptive
        restart of every lane: `(state, traces [4][B], stop [B])`, with
        every lane's merits and residuals read in one host sync."""
        for _ in range(self.inner):
            state = self.one_iter(state)
        x, y, ax, it, restarts, extra = state
        dense = self.dense
        if dense:
            ax = self._dense_apply_a(x[0])
        tol = self.cfg.tol_grad if self.cfg.tol_grad is not None else self.cfg.tol_viol
        if self.pcfg.restart == "adaptive":
            xs_sum, y_sum, ax_sum, win, merit_last = extra
            wfs = [float(max(w, 1)) for w in win]
            x_avg = tuple(_lane_div(s, wfs) for s in xs_sum)
            y_avg = _lane_div(y_sum, wfs)
            ax_avg = self._dense_apply_a(x_avg[0]) if dense else _lane_div(ax_sum, wfs)
            res_c = self.residuals(x, y, ax)
            res_a = self.residuals(x_avg, y_avg, ax_avg)
            merit = lambda r: torch.maximum(r[4], torch.maximum(r[2], r[3]))  # noqa: E731
            host = torch.stack([merit(res_c), merit(res_a), *res_c[2:], *res_a[2:]]).tolist()
            do, adopt, kept = [], [], []
            restarts, merit_last, win = list(restarts), list(merit_last), list(win)
            for ln in range(self.B):
                merit_c, merit_a = _f32(host[0][ln]), _f32(host[1][ln])
                merit_cand = min(merit_a, merit_c)
                d = bool(merit_cand <= _f32(self.pcfg.restart_threshold) * merit_last[ln])
                a = d and merit_a < merit_c
                do.append(d)
                adopt.append(a)
                kept.append([host[k][ln] for k in ((5, 6, 7) if a else (2, 3, 4))])
                if d:
                    win[ln], merit_last[ln], restarts[ln] = 0, merit_cand, restarts[ln] + 1
            adopt, keep = (_lane_select(f, y.device) for f in (adopt, [not d for d in do]))
            x = tuple(_pick(adopt, a, c) for a, c in zip(x_avg, x))
            y, ax = _pick(adopt, y_avg, y), _pick(adopt, ax_avg, ax)
            res = tuple(_pick(adopt, a, c) for a, c in zip(res_a, res_c))
            xs_sum = tuple(_pick(keep, s, torch.zeros_like(s)) for s in xs_sum)
            y_sum = _pick(keep, y_sum, torch.zeros_like(y_sum))
            ax_sum = None if dense else _pick(keep, ax_sum, torch.zeros_like(ax_sum))
            extra = (xs_sum, y_sum, ax_sum, win, merit_last)
        else:
            res = self.residuals(x, y, ax)
            kept = (list(zip(*torch.stack(res[2:]).tolist())) if tol is not None
                    else [None] * self.B)
        if tol is None:
            stop = [False] * self.B
        else:
            t = float(_f32(tol))
            stop = [pr <= t and dr <= t and gap <= t for pr, dr, gap in kept]
        po, _, pr, dr, gap = res
        traces = tuple(v.float() for v in (po, dr, pr, gap))
        return _BState(x, y, None if dense else ax, it, restarts, extra), traces, stop

    @property
    def inner(self) -> int:
        total = int(self.cfg.total_iter_budget)
        return max(1, min(int(self.cfg.check_every), total))

    def initial_state(self) -> _BState:
        """Every lane's warm-start point: y0 = lam0, x0 = Proj_C(-(A'y0 + c) / gamma_floor)."""
        y0 = self.lam0.float()
        x0 = tuple(xs.float() for xs in self.obj.primal_candidate(y0, self.cfg.gammas[-1]))
        if self.dense:
            l_max = self.mb.idx.shape[-1]
            x0 = (torch.cat([F.pad(xs, (0, l_max - xs.shape[-1])) for xs in x0], dim=1),)
            ax0 = None
        else:
            ax0 = self.obj.apply_A(x0).float()
        scheme, B = self.pcfg.restart, self.B
        if scheme in ("ergodic", "adaptive"):
            extra = (tuple(torch.zeros_like(xs) for xs in x0), torch.zeros_like(y0),
                     None if self.dense else torch.zeros_like(ax0), [0] * B)
            if scheme == "adaptive":
                extra = extra + ([_f32(np.inf)] * B,)
        elif scheme == "halpern":
            extra = (x0, y0, ax0, _f32(0.0))
        else:
            extra = ()
        return _BState(x0, y0, ax0, 0, [0] * B, extra)

    def run(self) -> RawSolve:
        """The checks of every lane until each has stopped or the budget is
        spent; a stopped lane's state and traces stay as they were."""
        total = int(self.cfg.total_iter_budget)
        n_checks = -(-total // self.inner)
        B, state = self.B, self.initial_state()
        done, chunks, cols = [False] * B, [0] * B, []
        for _ in range(n_checks):
            active = [not d for d in done]
            new, traces, stop = self._check(state)
            state = _keep(active, _lane_select(active, state.y.device), new, state)
            cols.append(torch.stack(traces))  # [4, B]; a stopped lane's are backfilled
            chunks = [c + int(a) for c, a in zip(chunks, active)]
            done = [d or (a and s) for d, a, s in zip(done, active, stop)]
            if all(done):
                break
        bufs = torch.stack(cols, dim=-1)  # [4, B, checks run]
        used = torch.tensor(chunks, device=bufs.device)
        pos = torch.arange(n_checks, device=bufs.device)
        bufs = F.pad(bufs, (0, n_checks - bufs.shape[-1]))
        last = bufs.gather(2, (used - 1).clamp_min(0).view(1, B, 1).expand(4, B, 1))
        bufs = torch.where(pos < used[:, None], bufs, last)
        x, y, ax = state.x, state.y, state.ax
        if self.dense:
            ax = self._dense_apply_a(x[0])
        pobj = self.residuals(x, y, ax)[0]
        if self.dense:
            merged, parts, off = x[0], [], 0
            for rows_i, len_i in self.split_shapes:
                parts.append(merged[:, off:off + rows_i, :len_i])
                off += rows_i
            x = tuple(parts)
        return RawSolve(
            lam=y,
            x_slabs=x,
            g=pobj,
            stats=(StageStats(g=bufs[0], grad_norm=bufs[1], max_violation=bufs[2]),),
            sigma_sq=torch.tensor(self.sigma_sq, dtype=torch.float32),
            etas=torch.tensor(self.taus, dtype=torch.float32).view(B, 1),
            iters=torch.tensor([[c * self.inner] for c in chunks], dtype=torch.int32),
            restarts=torch.tensor(state.restarts, dtype=torch.int32),
        )


def pdhg_raw_solve_batched(
    stacked: BucketedInstance,
    lam0: torch.Tensor,
    cfg: MaximizerConfig,
    normalize: bool,
    fused_oracle: bool = False,
    sigma_sq: Optional[torch.Tensor] = None,
    pcfg: PDHGEngineConfig = PDHGEngineConfig(),
) -> RawSolve:
    """The PDHG solve of every lane of a stacked instance from `lam0`
    [B, m*J] (the reference's `jax.vmap(pdhg_raw_solve)`): every `RawSolve`
    field gains the lane dimension.  Jacobi-normalizes each lane when asked;
    ``sigma_sq`` [B] skips the power iteration of every lane."""
    if normalize:
        stacked = normalize_lanes(stacked)
    obj = BatchedObjective(stacked)
    if sigma_sq is None:
        sigma_sq = obj.power_iteration(cfg.seed, iters=cfg.power_iters)
    return PDHGBatchedCore(obj, lam0, cfg, pcfg, fused_oracle=fused_oracle,
                           sigma_sq=sigma_sq).run()


def pdhg_raw_solve(
    inst: BucketedInstance,
    lam0: torch.Tensor,
    cfg: MaximizerConfig,
    normalize: bool,
    fused_oracle: bool = False,
    sigma_sq: Optional[torch.Tensor] = None,
    pcfg: PDHGEngineConfig = PDHGEngineConfig(),
) -> RawSolve:
    """Single-process structured PDHG solve -> RawSolve.

    `agd_raw_solve`'s contract: Jacobi-normalizes on the device when asked,
    and runs the power iteration only when no `sigma_sq` is given.
    """
    if normalize:
        inst, _ = normalize_rows_traced(inst)
    obj = MatchingObjective(inst)
    if sigma_sq is None:
        sigma_sq = obj.power_iteration(cfg.seed, iters=cfg.power_iters)
    return PDHGCore(obj, lam0, cfg, pcfg, fused_oracle=fused_oracle,
                    sigma_sq=sigma_sq).run()


class PDHGEngine:
    """Engine-protocol wrapper over `pdhg_raw_solve`."""

    name = "pdhg"

    @staticmethod
    def raw_solve(
        inst,
        lam0,
        cfg: MaximizerConfig,
        *,
        normalize: bool,
        fused_oracle: bool = False,
        sigma_sq=None,
    ) -> RawSolve:
        return pdhg_raw_solve(inst, lam0, cfg, normalize, fused_oracle, sigma_sq)


PDHG_ENGINE = PDHGEngine()


# ---------------------------------------------------------------------------
# Sharded solve: the same core over torch.distributed.
# ---------------------------------------------------------------------------


def solve_pdhg_sharded(
    inst: BucketedInstance,
    cfg: MaximizerConfig = MaximizerConfig(),
    dist=None,
    pcfg: PDHGEngineConfig = PDHGEngineConfig(),
    lam0: Optional[torch.Tensor] = None,
    projection=None,
    *,
    device=None,
) -> SolveResult:
    """Column-sharded PDHG (paper §4.4 layout), one process per card.

    Each process keeps its block of rows (`shard_instance`, moved to
    `device` when given) and runs the engine core with two hooks: partial
    sums cross processes through a sum all_reduce (the `A x+` vector once per
    iteration; the residual scalars once per check), and the early stop
    takes the same unanimous vote as `DistributedMaximizer`.  Without a
    process group the solve is the single-process one (world size 1).

    Instances should be normalized beforehand (`normalize_rows`): row norms
    are a global reduction.  `dist.comm_mode`/`compress` are ignored (a plain
    sum, as in the reference); `dist.fused_oracle` fuses the prox step.
    """
    import torch.distributed as tdist

    from repro_torch.core.sharding import (
        DistConfig, all_converged, all_reduce_sum, shard_instance,
    )

    dist = dist or DistConfig()
    joined = tdist.is_initialized()
    rank, world = (tdist.get_rank(), tdist.get_world_size()) if joined else (0, 1)
    local = shard_instance(inst, rank, world)
    if device is not None:
        local = local.to(device)
    obj = MatchingObjective(local, projection=projection or UnitSimplexProjection(),
                            include_rhs=False)
    reduce_sum = all_reduce_sum if joined else None
    sigma_sq = obj.power_iteration(cfg.seed, iters=cfg.power_iters, reduce=reduce_sum)
    lam = (torch.zeros(inst.dual_dim, dtype=torch.float32, device=local.device)
           if lam0 is None else lam0.float().to(local.device))
    raw = PDHGCore(obj, lam, cfg, pcfg, fused_oracle=dist.fused_oracle, sigma_sq=sigma_sq,
                   reduce_sum=reduce_sum,
                   stop_reduce=all_converged if joined else None).run()
    return SolveResult(
        lam=raw.lam,
        x_slabs=raw.x_slabs,
        g=raw.g,
        stats=raw.stats,
        sigma_sq=raw.sigma_sq,
        steps=(float(raw.etas[0]),),
        iters_used=(int(raw.iters[0]),),
        restarts=int(raw.restarts),
    )
