"""The tenant axis: one continuation solve over B stacked instances of one
shape (the port of the reference's `jax.vmap(_raw_solve)`,
`repro.service.engine.compiled_batch_solver`).

A stacked instance carries a leading tenant dimension B on every slab
(`idx [B, n, L]`, `coeff [B, m, n, L]`, `cost`/`mask [B, n, L]`) and on the
rhs (`[B, m*J]`); `stack_lanes` builds one, `lane_instance` views lane b.
The AGD stage loop runs once over `[B, m*J]` duals, every lane with its own
momentum counter, previous objective, adaptive restart, step size and
sigma_max(A)^2 estimate.  The oracle of a batched iteration is:

  * fused (`fused_oracle=True`): ONE batched call of the one-pass oracle
    (`kernels.ops.fused_dual_oracle_batched_call`): on the card one oracle
    launch for every lane and bucket of width <= 32 and one finalize, each
    lane bitwise its own solo call;
  * unfused: the plain oracle as one pass over the [B, ...] slabs: A^T lam
    a gather at lane-offset indices (`b*m*J + k*J + idx`), the candidate
    and the projection over every lane at once, A x ONE `binned_segment_sum`
    per bucket over lane-offset bins planned once per objective
    (`lane_segment_plan`), whose every bin holds its slots in the solo
    order.  The scalars of a lane (c'x, ||x||^2, lam'grad, and the power
    iteration's norms) are reduced over that lane's slice by the solo
    call's own op, since a reduction over the lane axis sums in another
    order.  So each lane's oracle and power iteration are bitwise its solo
    one (on the card too; rows wider than 32 are projected lane by lane
    there, because the card's cumsum chunks a row by the row count).

Early stopping follows JAX's batched `while_loop`: the batch runs chunk by
chunk until every lane has converged (or the budget is spent); a lane that
has converged keeps its carry and its traces frozen while the others run
on (its oracle is still evaluated and its result discarded, as the
reference's vmapped loop does), and `iters_used` is per lane.  The host
waits once per chunk.  The Jacobi normalisation runs once per solve, lane
by lane (`normalize_lanes`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch import telemetry
from repro_torch.core import objective as cobj
from repro_torch.core.maximizer import MaximizerConfig, StageStats, step_size
from repro_torch.core.objective import (
    DualEval,
    MatchingObjective,
    SegmentPlan,
    _vdot,
    binned_segment_sum,
    inv_gamma,
    lane_segment_plan,
    normalize_rows_traced,
)
from repro_torch.core.projections import UnitSimplexProjection
from repro_torch.instances.buckets import Bucket, BucketedInstance, dequantize_bucket

__all__ = [
    "BatchedObjective",
    "batched_continuation",
    "gather_lanes",
    "lane_instance",
    "lane_offsets",
    "normalize_lanes",
    "project_lanes",
    "stack_lanes",
]


def lane_instance(stacked: BucketedInstance, b: int) -> BucketedInstance:
    """Lane `b` of a stacked instance: views of its [B, ...] tensors."""
    opt = lambda t: None if t is None else t[b]
    return dataclasses.replace(
        stacked,
        buckets=tuple(
            dataclasses.replace(bk, idx=bk.idx[b], coeff=bk.coeff[b], cost=bk.cost[b],
                                mask=bk.mask[b], coeff_scale=opt(bk.coeff_scale),
                                cost_scale=opt(bk.cost_scale))
            for bk in stacked.buckets),
        rhs=stacked.rhs[b],
        pack_info=None,
    )


def stack_lanes(insts: Sequence[BucketedInstance]) -> BucketedInstance:
    """Instances of one shape stacked tensor by tensor along a new leading
    lane dimension (a copy, on the instances' device).  The static fields
    and the formulation are the first instance's; the caller checks that the
    shapes agree (`service.pool.stack_instances`)."""
    first = insts[0]
    stack = lambda ts: None if ts[0] is None else torch.stack(list(ts))
    buckets = []
    for k, b in enumerate(first.buckets):
        lanes = [inst.buckets[k] for inst in insts]
        buckets.append(Bucket(
            idx=stack([x.idx for x in lanes]), coeff=stack([x.coeff for x in lanes]),
            cost=stack([x.cost for x in lanes]), mask=stack([x.mask for x in lanes]),
            length=b.length, coeff_scale=stack([x.coeff_scale for x in lanes]),
            cost_scale=stack([x.cost_scale for x in lanes])))
    return dataclasses.replace(first, buckets=tuple(buckets),
                               rhs=torch.stack([inst.rhs for inst in insts]), pack_info=None)


def gather_lanes(coeff: torch.Tensor, idx_off: torch.Tensor, lam: torch.Tensor,
                 J: int) -> torch.Tensor:
    """(A^T lam) of one stacked slab ([B, m, n, L] coeff) in every lane,
    [B, n, L]: the solo `gather_at_lam` arithmetic (family products summed
    in family order) at lane-offset indices `idx_off` = b*m*J + idx (int64
    [B, n, L]) into the flat [B*m*J] duals."""
    flat = lam.reshape(-1)
    atl = coeff[:, 0] * flat[idx_off]
    for k in range(1, coeff.shape[1]):
        atl = atl + coeff[:, k] * flat[idx_off + k * J]
    return atl


def lane_offsets(idx: torch.Tensor, mJ: int) -> torch.Tensor:
    """`idx` [B, n, L] offset by its lane: b*mJ + idx, int64."""
    lanes = torch.arange(idx.shape[0], device=idx.device, dtype=torch.int64)
    return idx.long() + lanes.view(-1, *[1] * (idx.dim() - 1)) * mJ


def project_lanes(proj, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`proj` over the rows of every lane of a [B, n, L] slab at once, each
    lane bitwise its solo projection.  The plain simplex projection of rows
    wider than 32 on the card goes lane by lane: PyTorch's CUDA cumsum
    chunks a row by the number of rows, so a [B*n, L] scan may round apart
    from the solo [n, L] one."""
    if isinstance(proj, UnitSimplexProjection) and v.is_cuda and v.shape[-1] > 32:
        return torch.stack([proj(v[b], mask[b]) for b in range(v.shape[0])])
    return proj(v, mask)


class BatchedObjective:
    """The dual oracle of B stacked instances: `calculate(lam [B, m*J],
    gamma)` returns a `DualEval` whose every field has the lane dimension
    (g, c'x and the ridge term [B]; grad and A x [B, m*J]; x [B, n, L] per
    bucket).  `gamma` is shared by the lanes.  The lanes share the
    formulation (`stack_lanes` keeps the first instance's), so lane 0's
    projections and term scales are every lane's."""

    def __init__(self, stacked: BucketedInstance, *, fused_oracle: bool = False):
        self.instance = stacked
        self.fused_oracle = fused_oracle
        self.lanes = [MatchingObjective(lane_instance(stacked, b), fused_oracle=fused_oracle)
                      for b in range(stacked.rhs.shape[0])]
        self._plan = None
        self._planned = False
        self._idx_off: Optional[tuple[torch.Tensor, ...]] = None
        self._seg: Optional[tuple[SegmentPlan, ...]] = None

    @property
    def num_lanes(self) -> int:
        return len(self.lanes)

    @property
    def _buckets(self) -> tuple[Bucket, ...]:
        """fp32 compute views of the stacked buckets (fp32 storage returns
        the instance's own)."""
        return tuple(dequantize_bucket(b) for b in self.instance.buckets)

    def _proj(self, i: int):
        return self.lanes[0]._proj(i)

    def _scaled_cost(self, b: Bucket) -> torch.Tensor:
        return self.lanes[0]._scaled_cost(b)

    def kernel_plan(self):
        """The batched oracle's plan over the stacked slabs, built once on
        the card (`kernels.ops.plan_batched_oracle`); None on the CPU."""
        if not self._planned:
            from repro_torch.kernels import ops as kops

            proj = self.lanes[0]._assert_fused_ok("fused dual oracle")
            inst = self.instance
            self._plan = kops.plan_batched_oracle(
                inst.buckets, inst.num_destinations, radius=proj.radius,
                inequality=proj.inequality)
            self._planned = True
        return self._plan

    # -- the plain oracle over every lane at once ------------------------------

    def lane_indices(self) -> tuple[torch.Tensor, ...]:
        """Each bucket's idx offset by its lane, `b*m*J + idx` (int64
        [B, n, L]), built once: index the flat [B*m*J] duals."""
        if self._idx_off is None:
            inst = self.instance
            mJ = inst.num_families * inst.num_destinations
            self._idx_off = tuple(lane_offsets(b.idx, mJ) for b in inst.buckets)
        return self._idx_off

    def segment_plans(self) -> tuple[SegmentPlan, ...]:
        """Each bucket's `lane_segment_plan`, sorted once per objective."""
        if self._seg is None:
            inst = self.instance
            self._seg = tuple(lane_segment_plan(b.idx, inst.num_families,
                                                inst.num_destinations)
                              for b in inst.buckets)
        return self._seg

    def gather_at_lam(self, i: int, coeff: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
        """(A^T lam) of bucket i in every lane, [B, n, L]: the solo
        `gather_at_lam` arithmetic (family products summed in family order)
        at lane-offset indices."""
        return gather_lanes(coeff, self.lane_indices()[i], lam, self.instance.num_destinations)

    def primal_candidate(self, lam: torch.Tensor, gamma: float) -> tuple[torch.Tensor, ...]:
        """x*_gamma(lam) per bucket of every lane, [B, n, L] each (the solo
        `MatchingObjective.primal_candidate` on the plain path)."""
        lane0 = self.lanes[0]
        ginv = inv_gamma(lane0._scaled_gamma(gamma))
        buckets = self._buckets
        vs = [-(self.gather_at_lam(i, b.coeff, lam) + self._scaled_cost(b)) * ginv
              for i, b in enumerate(buckets)]
        projs = [self._proj(i) for i in range(len(buckets))]
        if (isinstance(projs[0], UnitSimplexProjection) and projs[0].use_kernel
                and len(set(projs)) == 1):
            # the simplex kernel's wide rows scan in chunks set by the row
            # count too: one whole call per lane, on the lane's own plan
            from repro_torch.kernels import ops as kops

            per = [kops.fused_project_simplex_call(
                       [v[b] for v in vs], [bk.mask[b] for bk in buckets],
                       radius=projs[0].radius, inequality=projs[0].inequality,
                       plan=lane.kernel_plan("simplex_proj"))
                   for b, lane in enumerate(self.lanes)]
            return tuple(torch.stack(xs) for xs in zip(*per))
        return tuple(project_lanes(p, v, b.mask) for p, v, b in zip(projs, vs, buckets))

    def apply_A(self, x_slabs) -> torch.Tensor:
        """A x of every lane, [B, m*J]: one fixed-order segment sum per
        bucket over the lane-offset bins."""
        inst = self.instance
        B, J = self.num_lanes, inst.num_destinations
        ax = torch.zeros((B, inst.num_families * J),
                         dtype=torch.promote_types(x_slabs[0].dtype, torch.float32),
                         device=inst.device)
        for b, x, plan in zip(self._buckets, x_slabs, self.segment_plans()):
            contrib = b.coeff * (x * b.mask)[:, None]
            part = binned_segment_sum(b.idx, contrib.reshape(-1, *contrib.shape[2:]), J, plan)
            ax = ax + part.reshape(B, -1)
        return ax

    def apply_AT(self, lam: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """A^T lam per bucket of every lane, [B, n, L] each."""
        return tuple(self.gather_at_lam(i, b.coeff, lam) * b.mask
                     for i, b in enumerate(self._buckets))

    def calculate(self, lam: torch.Tensor, gamma: float) -> DualEval:
        if not self.fused_oracle:
            return self._calculate_plain(lam, gamma)
        from repro_torch.kernels import ops as kops

        proj = self.lanes[0]._assert_fused_ok("fused dual oracle")
        inst = self.instance
        x_slabs, ax, lin, sq = kops.fused_dual_oracle_batched_call(
            inst.buckets, lam, gamma, num_destinations=inst.num_destinations,
            radius=proj.radius, inequality=proj.inequality, plan=self.kernel_plan())
        ridge = 0.5 * gamma * sq
        grad = ax - inst.rhs
        g = lin + ridge + torch.linalg.vecdot(lam, grad)
        return DualEval(g=g, grad=grad, x_slabs=x_slabs, primal_linear=lin,
                        primal_ridge=ridge, ax=ax)

    def _calculate_plain(self, lam: torch.Tensor, gamma: float) -> DualEval:
        """The unfused oracle of every lane in one pass over the slabs; each
        lane's scalars by its solo call's ops on its slices."""
        x_slabs = self.primal_candidate(lam, gamma)
        ax = self.apply_A(x_slabs)
        grad = ax - self.instance.rhs
        lins, ridges, gs = [], [], []
        for b, lane in enumerate(self.lanes):
            lin, ridge = lane._primal_terms(tuple(x[b] for x in x_slabs), gamma)
            lins.append(lin)
            ridges.append(torch.as_tensor(ridge))
            gs.append(lin + ridge + _vdot(lam[b], grad[b]))
        return DualEval(g=torch.stack(gs), grad=grad, x_slabs=x_slabs,
                        primal_linear=torch.stack(lins), primal_ridge=torch.stack(ridges),
                        ax=ax)

    def power_iteration(self, seed: int, iters: int = 30) -> torch.Tensor:
        """Each lane's sigma_max(A)^2 estimate, [B]: the solo power iteration
        (`MatchingObjective.power_iteration`, the same start vector in every
        lane) over all lanes at once, each lane's norm by its own reduction."""
        inst = self.instance
        u0 = cobj.start_vector(inst.dual_dim, seed, inst.device)
        u = u0.expand(self.num_lanes, -1).contiguous()
        norms = None
        for _ in range(iters):
            u = self.apply_A(self.apply_AT(u / self._lane_norms(u)[:, None]))
            norms = self._lane_norms(u)
        return norms

    @staticmethod
    def _lane_norms(u: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.linalg.vector_norm(u[b]) for b in range(u.shape[0])])


def normalize_lanes(stacked: BucketedInstance) -> BucketedInstance:
    """Jacobi row normalisation of every lane (`normalize_rows_traced` of
    each lane, restacked)."""
    B = stacked.rhs.shape[0]
    return stack_lanes([normalize_rows_traced(lane_instance(stacked, b))[0] for b in range(B)])


class _Carry(NamedTuple):
    lam_prev: torch.Tensor  # [B, D]
    lam: torch.Tensor  # [B, D]
    tk: torch.Tensor  # [B] momentum counter (float)
    g_prev: torch.Tensor  # [B]


def _agd_body(calculate: Callable, gamma: float, eta: torch.Tensor, *, acceleration: bool,
              adaptive_restart: bool) -> Callable:
    """One accelerated projected dual-ascent iteration of every lane: the
    solo body (`core.maximizer._agd_body`) with per-lane scalars."""

    def body(carry: _Carry):
        mu = carry.lam
        if acceleration:
            beta = (carry.tk - 1.0) / (carry.tk + 2.0)
            mu = mu + beta[:, None] * (carry.lam - carry.lam_prev)
        mu = torch.clamp_min(mu, 0.0)
        ev = calculate(mu, gamma)
        lam_next = torch.clamp_min(mu + eta[:, None] * ev.grad, 0.0)
        if adaptive_restart:
            tk_next = torch.where(ev.g < carry.g_prev, 1.0, carry.tk + 1.0)
        else:
            tk_next = carry.tk + 1.0
        gn = torch.linalg.vector_norm(ev.grad, dim=-1)
        viol = torch.clamp_min(ev.grad, 0.0).amax(dim=-1)
        return _Carry(carry.lam, lam_next, tk_next, ev.g), (ev.g, gn, viol)

    return body


def _init_carry(lam0: torch.Tensor) -> _Carry:
    B = lam0.shape[0]
    return _Carry(lam0, lam0, torch.ones(B, dtype=lam0.dtype, device=lam0.device),
                  torch.full((B,), -torch.inf, dtype=lam0.dtype, device=lam0.device))


def _run(body: Callable, carry: _Carry, steps: int):
    """`steps` iterations of `body`; each trace stacked as [B, steps]."""
    traces = []
    for _ in range(steps):
        carry, t = body(carry)
        traces.append(t)
    return carry, tuple(torch.stack(ts, dim=-1) for ts in zip(*traces))


def _stage_early(body: Callable, carry: _Carry, iters: int, *, check_every: int,
                 tol_grad: Optional[float], tol_viol: Optional[float]):
    """The early-stopping stage of every lane, with the semantics of the
    reference's vmapped `while_loop` of scanned chunks: chunks run while any
    lane is unconverged and the budget lasts; a converged lane's carry and
    traces stay as they were.  Returns `(carry, traces [B, budget],
    steps_used [B])`, each lane's traces padded past its own steps with its
    last computed value."""
    chunk = max(1, min(int(check_every), int(iters)))
    n_chunks = -(-int(iters) // chunk)
    B, dev = carry.lam.shape[0], carry.lam.device
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    chunks = torch.zeros(B, dtype=torch.int64, device=dev)
    bufs = [torch.zeros(B, n_chunks * chunk, dtype=carry.lam.dtype, device=dev)
            for _ in range(3)]
    for c in range(n_chunks):
        active = ~done
        new, traces = _run(body, carry, chunk)
        carry = _Carry(*(torch.where(active.view(-1, *[1] * (n.dim() - 1)), n, o)
                         for n, o in zip(new, carry)))
        for buf, t in zip(bufs, traces):
            part = buf[:, c * chunk:(c + 1) * chunk]
            part.copy_(torch.where(active[:, None], t, part))
        chunks = chunks + active.long()
        gs, gns, viols = traces
        stop = torch.ones(B, dtype=torch.bool, device=dev)
        if tol_grad is not None:
            stop = stop & (gns[:, -1] <= tol_grad * torch.clamp_min(gs[:, -1].abs(), 1.0))
        if tol_viol is not None:
            stop = stop & (viols[:, -1] <= tol_viol)
        done = done | (active & stop)
        if bool(done.all()):
            break
    used = chunks * chunk
    last = torch.clamp_min(used - 1, 0)
    pos = torch.arange(n_chunks * chunk, device=dev)
    bufs = [torch.where(pos[None, :] < used[:, None], b, b.gather(1, last[:, None]))
            for b in bufs]
    return carry, bufs, used


def batched_continuation(
    obj: BatchedObjective,
    lam0: torch.Tensor,  # [B, D]
    cfg: MaximizerConfig,
    sigma_sq: torch.Tensor,  # [B]
):
    """The continuation solve of every lane from `lam0`: one AGD stage per
    gamma of the schedule (early-stopping per lane when configured), then
    the final `calculate`.  Returns `(lam [B, D], final DualEval, stats,
    etas [B, S], iters [B, S])`."""
    lam = lam0
    stats: list[StageStats] = []
    etas, iters = [], []
    B = lam0.shape[0]
    for k, gamma in enumerate(cfg.gammas):
        eta = step_size(cfg, sigma_sq, gamma).to(lam.dtype)
        body = _agd_body(obj.calculate, gamma, eta, acceleration=cfg.acceleration,
                         adaptive_restart=cfg.adaptive_restart)
        with telemetry.span("stage", device=lam.device, stage=k, gamma=float(gamma)):
            if cfg.early_stop:
                carry, (bg, bgn, bv), used = _stage_early(
                    body, _init_carry(lam), cfg.iters_per_stage,
                    check_every=cfg.check_every, tol_grad=cfg.tol_grad,
                    tol_viol=cfg.tol_viol)
            else:
                carry, (bg, bgn, bv) = _run(body, _init_carry(lam), cfg.iters_per_stage)
                used = torch.full((B,), cfg.iters_per_stage, dtype=torch.int64,
                                  device=lam.device)
        lam = carry.lam
        stats.append(StageStats(g=bg, grad_norm=bgn, max_violation=bv))
        etas.append(eta)
        iters.append(used)
    final = obj.calculate(lam, cfg.gammas[-1])
    return (lam, final, tuple(stats), torch.stack(etas, dim=-1),
            torch.stack(iters, dim=-1).to(torch.int32))
