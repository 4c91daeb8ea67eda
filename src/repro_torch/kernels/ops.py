"""Dispatch of the three kernels (port of `repro.kernels.ops`).

  fused_dual_oracle_call      one-pass oracle, every bucket   dual_oracle.oracle_call
  fused_dual_oracle_batched_call  the same over B stacked     dual_oracle.oracle_call
                              instances (the tenant axis)     (a plan_batched plan)
  fused_dual_primal_call      the primal step, every bucket   dual_primal.primal_call
  fused_dual_primal_rows      the primal step of requested    dual_primal.rows_call
                              rows (the serving query)
  fused_project_simplex_call  projection, every bucket        simplex_proj.simplex_call
  fused_pdhg_step_call        PDHG prox step, every bucket    dual_oracle.oracle_call
  fused_pdhg_step_batched_call  the same over B stacked       dual_oracle.oracle_call
                              instances, tau per lane         (a plan_batched plan)
  fused_dual_oracle           one-pass oracle, one bucket     dual_oracle.dual_oracle
  fused_dual_primal           the primal step, one bucket     dual_primal.dual_primal
  fused_project_simplex       projection, one slab            simplex_proj.simplex_proj
  fused_pdhg_step             PDHG prox step, one bucket      dual_oracle.dual_oracle
                              (the reference's entry, for parity only)

The whole-call entry points are what `MatchingObjective` calls: one kernel
plan per objective (`plan_slab_kernel`, built once on the card), one oracle
launch and one finalize per call on the main path, one launch of the
primal step or of the projection per call on the other paths (one more per
bucket wider than 32).  The PDHG engine's fused prox step is the oracle
with an iterate-dependent cost (`fused_pdhg_step`): its whole-call form
writes persistent `cost_eff` buffers in place and makes one oracle call
through a plan built once per solve over them (`plan_pdhg_step`); over a
stack of instances (the batched PDHG solve) the buffers are [B, n, L], each
lane has its own tau, and one batched oracle call with a 1/gamma per lane
takes the step of every lane (`plan_pdhg_step_batched`).

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
`width_routed` counts those buckets, once per call.  `bucketize` only makes power-of-two
widths, so the count stays 0 unless some source has more than 8192 edges.

The kernels need no row padding: they mask the ragged tail themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import dual_oracle as kdo
from repro_torch.kernels import dual_primal as kdp
from repro_torch.kernels import ref as kref
from repro_torch.kernels import simplex_proj as ksp
from repro_torch.kernels.dual_oracle import MAX_FUSED_LENGTH

__all__ = [
    "MAX_FUSED_LENGTH",
    "fused_dual_oracle",
    "fused_dual_oracle_batched_call",
    "fused_dual_oracle_call",
    "fused_dual_primal",
    "fused_dual_primal_call",
    "fused_dual_primal_rows",
    "fused_project_simplex",
    "fused_project_simplex_call",
    "fused_pdhg_step",
    "fused_pdhg_step_batched_call",
    "fused_pdhg_step_call",
    "PDHGStep",
    "PDHGStepBatched",
    "oracle_hist_partial_bytes",
    "oracle_slab_slot_bytes",
    "plan_batched_oracle",
    "plan_pdhg_step",
    "plan_pdhg_step_batched",
    "plan_rows",
    "plan_slab_kernel",
    "width_routed",
]

width_routed = 0  # calls sent to a plain version by the width rule

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _kernel_width(L: int) -> bool:
    return _is_pow2(L) and L <= MAX_FUSED_LENGTH


def _on_card(t: torch.Tensor) -> bool:
    """CUDA tensors take the kernels, CPU tensors the plain versions; any
    other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel path for device {t.device}")
    return t.device.type == "cuda"


def _use_kernel(t: torch.Tensor) -> bool:
    """Whether a call on slab `t` [..., L] goes to its kernel (CUDA) or to
    its plain version (CPU, or a width the kernels do not take, counted in
    `width_routed`); any other device raises."""
    global width_routed
    if not _kernel_width(t.shape[-1]):
        width_routed += 1
        return False
    return _on_card(t)


def oracle_slab_slot_bytes(num_families: int, slab_dtype="float32") -> int:
    """HBM bytes per slab slot of one fused-oracle call: the idx read (int32),
    coeff/cost/mask reads at the storage width, and the x write (storage
    width for float slabs, fp32 for int8)."""
    name = str(slab_dtype).removeprefix("torch.")
    size = _ITEMSIZE[name]
    return 4 + (num_families + 2) * size + (4 if name == "int8" else size)


def oracle_hist_partial_bytes(grid: int, num_families: int, num_destinations: int,
                              hist_mode: int = kdo.HIST_SHARED) -> int:
    """Per-call HBM traffic of the oracle's int64 A x row for a launch of
    `grid` blocks: the row zeroed and read by the finalize, and with the
    histogram in shared memory at most one atomic add per bin and block
    (HIST_SHARED); with the histogram in global memory (HIST_GLOBAL) the
    adds are one per contribution and not counted here."""
    row = 8 * num_families * num_destinations
    return 2 * row + (row * grid if hist_mode == kdo.HIST_SHARED else 0)


def plan_slab_kernel(kernel: str, buckets, num_destinations: int, *, radius: float = 1.0,
                     inequality: bool = True):
    """The plan of `kernel` ("dual_oracle", "dual_primal" or "simplex_proj")
    over the buckets of kernel widths, built once per objective on the card;
    None on the CPU or when no bucket has a kernel width.  The projection's
    plan is for the unfused oracle's candidates: fp32 slabs of the buckets'
    shapes (`MatchingObjective._buckets` widens narrow storage)."""
    if not _on_card(buckets[0].cost):
        return None
    slabs = [b for b in buckets if _kernel_width(b.cost.shape[-1])]
    if not slabs:
        return None
    if kernel == "simplex_proj":
        return ksp.plan_simplex([tuple(b.cost.shape) for b in slabs], torch.float32,
                                slabs[0].cost.device, radius=radius, inequality=inequality)
    return kdo.plan_slabs(kernel, slabs, num_destinations, radius=radius,
                          inequality=inequality)


def _routed(widths) -> list[int]:
    """Where the width rule sends a slab to its plain version, counted."""
    global width_routed
    ids = [i for i, L in enumerate(widths) if not _kernel_width(L)]
    width_routed += len(ids)
    return ids


def fused_dual_oracle_call(
    buckets,  # `Bucket`s sharing m, dtype and device
    lam: torch.Tensor,  # [m * J] fp32
    gamma: float,
    *,
    num_destinations: int,
    radius: float = 1.0,
    inequality: bool = True,
    plan=None,  # plan_slab_kernel("dual_oracle", ...), built here if None
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole one-pass oracle: `(x_slabs, ax [m*J], lin, sq)`.

    On the card one oracle launch for all buckets of width <= 32 (one more
    per wider bucket) and one finalize; on the CPU the plain whole call,
    bucket by bucket."""
    J = num_destinations
    routed = _routed([b.cost.shape[-1] for b in buckets])
    if not _on_card(buckets[0].cost) or len(routed) == len(buckets):
        return kref.dual_oracle_call_ref(buckets, lam, gamma, J, radius,
                                         inequality=inequality)
    if plan is None:
        plan = plan_slab_kernel("dual_oracle", buckets, J, radius=radius,
                                inequality=inequality)
    xs, ax, lin, sq = kdo.oracle_call(plan, lam, gamma)
    if not routed:
        return xs, ax, lin, sq
    xs = list(xs)
    for i in routed:  # plain version, its partials added after the kernel's
        b = buckets[i]
        x, hist, b_lin, b_sq = kref.dual_oracle_ref(
            b.idx, b.coeff, b.cost, b.mask, lam, gamma, J, radius,
            inequality=inequality, coeff_scale=b.coeff_scale, cost_scale=b.cost_scale)
        xs.insert(i, x)
        ax, lin, sq = ax + hist.reshape(-1), lin + b_lin, sq + b_sq
    return tuple(xs), ax, lin, sq


def plan_batched_oracle(buckets, num_destinations: int, *, radius: float = 1.0,
                        inequality: bool = True):
    """The oracle's plan over stacked buckets ([B, ...] tensors, the tenant
    axis) of kernel widths, built once per batched objective on the card;
    None on the CPU or when no bucket has a kernel width."""
    if not _on_card(buckets[0].cost):
        return None
    slabs = [b for b in buckets if _kernel_width(b.cost.shape[-1])]
    if not slabs:
        return None
    return kdo.plan_batched(slabs, num_destinations, radius=radius, inequality=inequality)


def fused_dual_oracle_batched_call(
    buckets,  # stacked `Bucket`s: [B, ...] tensors of one shape
    lam: torch.Tensor,  # [B, m * J] fp32
    gamma,  # a float shared by every lane, or a [B] tensor: gamma_b per lane
    *,
    num_destinations: int,
    radius: float = 1.0,
    inequality: bool = True,
    plan=None,  # plan_batched_oracle(...), built here if None
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole one-pass oracle of every lane of a stack of instances:
    `(x_slabs [B, n, L] each, ax [B, m*J], lin [B], sq [B])`, lane b's
    bitwise its own solo call's at its gamma.  On the card one oracle launch
    for every lane and bucket of width <= 32 (one more per wider bucket) and
    one finalize over [B, m*J]; on the CPU the plain call, lane by lane."""
    J = num_destinations
    routed = _routed([b.cost.shape[-1] for b in buckets])
    if not _on_card(buckets[0].cost) or len(routed) == len(buckets):
        return kref.dual_oracle_batched_ref(buckets, lam, gamma, J, radius,
                                            inequality=inequality)
    if plan is None:
        plan = plan_batched_oracle(buckets, J, radius=radius, inequality=inequality)
    xs, ax, lin, sq = kdo.oracle_call(plan, lam, gamma)
    if not routed:
        return xs, ax, lin, sq
    xs = list(xs)
    for i in routed:  # plain version, its partials added after the kernel's
        x, hist, b_lin, b_sq = kref.dual_oracle_batched_ref([buckets[i]], lam, gamma, J, radius,
                                                            inequality=inequality)
        xs.insert(i, x[0])
        ax, lin, sq = ax + hist, lin + b_lin, sq + b_sq
    return tuple(xs), ax, lin, sq


def plan_rows(buckets, num_destinations: int, *, radius: float = 1.0, inequality: bool = True):
    """The row-list plan of the primal step over every bucket of kernel
    width (fp32 or bf16), built once per snapshot on the card; None on the
    CPU.  Buckets of other widths take the plain version per query."""
    if not _on_card(buckets[0].cost):
        return None
    return kdp.plan_rows(buckets, num_destinations, radius=radius, inequality=inequality)


def fused_dual_primal_rows(
    buckets,
    requests,  # [(bucket, rows int64 [q])]
    lam: torch.Tensor,  # [m * J] fp32
    gamma: float,
    *,
    num_destinations: int,
    radius: float = 1.0,
    inequality: bool = True,
    plan=None,  # plan_rows(...) over `buckets`, built here if None
) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The primal step x = Pi( -(A^T lam + c)/gamma ) of the requested rows
    of each bucket: per request `(x [q, L] fp32, mask [q, L] fp32, idx
    [q, L] int32)`, x bitwise the full-slab step's rows (in fp32 for bf16
    slabs).  On the card one launch for every requested bucket of width <=
    32 (one more per wider bucket); on the CPU the plain version."""
    J = num_destinations
    plain = lambda reqs: kref.dual_primal_rows_ref(buckets, reqs, lam, gamma, J, radius,
                                                   inequality=inequality)
    if not _on_card(buckets[0].cost):
        return plain(requests)
    if plan is None:
        plan = plan_rows(buckets, J, radius=radius, inequality=inequality)
    routed = {i for i, (t, _) in enumerate(requests)
              if not _kernel_width(buckets[int(t)].cost.shape[-1])}
    kept = [r for i, r in enumerate(requests) if i not in routed]
    out = list(kdp.rows_call(plan, lam, gamma, kept)) if kept else []
    for i in sorted(routed):
        out.insert(i, plain([requests[i]])[0])
    return out


def fused_dual_primal_call(
    buckets,
    lam: torch.Tensor,  # [m * J] fp32
    gamma: float,
    *,
    num_destinations: int,
    radius: float = 1.0,
    inequality: bool = True,
    plan=None,  # plan_slab_kernel("dual_primal", ...), built here if None
) -> tuple[torch.Tensor, ...]:
    """The whole fused primal step: the x slabs, in the storage dtype (fp32
    for int8).  On the card one launch for all buckets of width <= 32 (one
    more per wider bucket); on the CPU each bucket's plain version."""
    J = num_destinations
    routed = _routed([b.cost.shape[-1] for b in buckets])
    plain = lambda b: kref.dual_primal_ref(
        b.idx, b.coeff, b.cost, b.mask, lam, gamma, J, radius, inequality=inequality,
        coeff_scale=b.coeff_scale, cost_scale=b.cost_scale)
    if not _on_card(buckets[0].cost) or len(routed) == len(buckets):
        return tuple(plain(b) for b in buckets)
    if plan is None:
        plan = plan_slab_kernel("dual_primal", buckets, J, radius=radius,
                                inequality=inequality)
    xs = list(kdp.primal_call(plan, lam, gamma))
    for i in routed:
        xs.insert(i, plain(buckets[i]))
    return tuple(xs)


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
    all fp32; x is in the storage dtype (fp32 for int8).
    """
    args = (idx, coeff, cost, mask, lam, gamma)
    kw = dict(radius=radius, inequality=inequality,
              coeff_scale=coeff_scale, cost_scale=cost_scale)
    if not _use_kernel(cost):
        return kref.dual_oracle_ref(*args, num_destinations, **kw)
    return kdo.dual_oracle(*args, num_destinations=num_destinations, **kw)


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


def fused_project_simplex_call(
    vs,  # [n, L] slabs, fp32 / bf16, one dtype and device
    masks,  # [n, L] each, the slabs' dtype
    *,
    radius: float = 1.0,
    inequality: bool = True,
    plan=None,  # plan_slab_kernel("simplex_proj", ...), built here if None
) -> tuple[torch.Tensor, ...]:
    """The projection of every slab of one call, each in its dtype.  On the
    card one launch for all slabs of width <= 32 (one more per wider slab);
    on the CPU each slab's plain version."""
    routed = _routed([v.shape[-1] for v in vs])
    plain = lambda i: kref.simplex_ref(vs[i], masks[i], radius, inequality=inequality)
    if not _on_card(vs[0]) or len(routed) == len(vs):
        return tuple(plain(i) for i in range(len(vs)))
    kept = [i for i in range(len(vs)) if i not in routed]
    if plan is None:
        plan = ksp.plan_simplex([tuple(vs[i].shape) for i in kept], vs[0].dtype,
                                vs[0].device, radius=radius, inequality=inequality)
    if plan.radius != float(radius) or plan.inequality != bool(inequality):
        raise ValueError("simplex_proj kernel: the plan is for another feasible set")
    outs = list(ksp.simplex_call(plan, [vs[i] for i in kept], [masks[i] for i in kept]))
    for i in routed:
        outs.insert(i, plain(i))
    return tuple(outs)


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


def _inv_tau(tau) -> float:
    """1/tau rounded to fp32, as a Python float (tau: a float or a 0-dim
    tensor, read once)."""
    return float(np.float32(1.0) / np.float32(float(tau)))


def _write_cost_eff(cost: torch.Tensor, x: torch.Tensor, inv_tau,
                    tmp: torch.Tensor, out: torch.Tensor) -> None:
    """out = cost - x * inv_tau, rounded twice as the reference computes it
    (a product, then a difference: two launches on the card, never an FMA).
    `inv_tau` is a Python float, or a [B, 1, 1] fp32 tensor of per-lane
    values for stacked slabs (the same fp32 product per element)."""
    torch.mul(x, inv_tau, out=tmp)
    torch.sub(cost, tmp, out=out)


def fused_pdhg_step(
    idx: torch.Tensor,  # [n, L] int32
    coeff: torch.Tensor,  # [m, n, L] fp32 compute view
    cost: torch.Tensor,  # [n, L] fp32
    mask: torch.Tensor,  # [n, L] fp32
    x: torch.Tensor,  # [n, L] fp32 current primal slab
    y: torch.Tensor,  # [m * J] fp32 current duals
    tau,  # primal step (float or 0-dim tensor)
    *,
    num_destinations: int,
    radius: float = 1.0,
    inequality: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One structured-PDHG primal prox step for one bucket: `(x_new, hist)`.

    The PDHG primal update `x+ = Proj_C(x - tau * (c + A'y))` is the dual
    oracle's `Proj_C(-(A'y + cost_eff) / gamma)` with `cost_eff = c - x/tau`
    and `gamma = 1/tau` (both rounded to fp32), so one oracle launch takes
    the prox step and emits this bucket's `hist = A x+` [m, J].  The slabs
    are fp32 compute views: `cost_eff` changes every iteration, so the
    quantized storage forms (a fixed per-bucket cost scale) do not apply.

    The reference's per-bucket entry, kept for parity with it: no solve
    calls it (the engine takes every bucket at once, `fused_pdhg_step_call`).
    """
    inv_tau = _inv_tau(tau)
    cost_eff = torch.empty_like(cost)
    _write_cost_eff(cost, x, inv_tau, torch.empty_like(x), cost_eff)
    x_new, hist, _, _ = fused_dual_oracle(
        idx, coeff, cost_eff, mask, y, inv_tau, num_destinations=num_destinations,
        radius=radius, inequality=inequality)
    return x_new, hist


@dataclasses.dataclass(frozen=True, eq=False)
class PDHGStep:
    """The fused PDHG prox step over every bucket of one solve.

    `slabs` are the buckets with their cost replaced by one persistent fp32
    `cost_eff` buffer each, which every call rewrites in place; `plan` is
    the oracle's plan over them (None on the CPU), built once: the buffers
    never move, and the plan's fixed-point shift depends only on idx, coeff,
    mask and the radius, so it holds for every iterate."""

    costs: tuple[torch.Tensor, ...]  # c per bucket (fp32 compute views)
    slabs: tuple[kdo.Slab, ...]  # idx, coeff and mask, cost = the cost_eff buffer
    scratch: torch.Tensor  # flat fp32: x * inv_tau of one bucket at a time
    num_destinations: int
    radius: float
    inequality: bool
    plan: Optional[kdo.SlabPlan]

    @property
    def launches_per_call(self) -> int:
        """Oracle launches of one call on the card (0 on the CPU)."""
        return 0 if self.plan is None else len(self.plan.launches)

    def write_cost_eff(self, x_slabs, inv_tau: float) -> None:
        """Each bucket's buffer = c - x * inv_tau, in place."""
        for c, x, s in zip(self.costs, x_slabs, self.slabs):
            _write_cost_eff(c, x, inv_tau, self.scratch[:x.numel()].view(x.shape), s.cost)


def plan_pdhg_step(
    buckets,  # fp32 compute views (`MatchingObjective._buckets`)
    costs,  # the cost of each bucket (fp32)
    *,
    num_destinations: int,
    radius: float = 1.0,
    inequality: bool = True,
) -> PDHGStep:
    """Allocate the `cost_eff` buffers of a solve and plan the oracle over
    them (on the card; on the CPU there is no plan)."""
    slabs = tuple(kdo.Slab(b.idx, b.coeff, torch.empty_like(c), b.mask)
                  for b, c in zip(buckets, costs))
    scratch = torch.empty(max(c.numel() for c in costs), dtype=torch.float32,
                          device=costs[0].device)
    plan = plan_slab_kernel("dual_oracle", slabs, num_destinations, radius=radius,
                            inequality=inequality)
    return PDHGStep(tuple(costs), slabs, scratch, num_destinations, float(radius),
                    bool(inequality), plan)


def fused_pdhg_step_call(
    step: PDHGStep,
    x_slabs,  # [n, L] fp32 per bucket: the current primal
    y: torch.Tensor,  # [m * J] fp32 current duals
    tau,  # primal step (float or 0-dim tensor)
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """The PDHG prox step of every bucket: `(x_new slabs, A x_new [m*J])`.

    Writes each bucket's `cost_eff = c - x * fp32(1/tau)` into the step's
    buffer, then makes one whole oracle call with gamma = fp32(1/tau): on
    the card one oracle launch for all buckets of width <= 32 and one
    finalize, A x exact in int64 fixed point; on the CPU the plain call,
    bucket by bucket."""
    inv_tau = _inv_tau(tau)
    step.write_cost_eff(x_slabs, inv_tau)
    xs, ax, _, _ = fused_dual_oracle_call(
        step.slabs, y, inv_tau, num_destinations=step.num_destinations,
        radius=step.radius, inequality=step.inequality, plan=step.plan)
    return xs, ax


@dataclasses.dataclass(frozen=True, eq=False)
class PDHGStepBatched:
    """The fused PDHG prox step over every bucket of B stacked instances of
    one shape, each lane with its own tau (fixed per solve).

    `slabs` are the stacked buckets with their cost replaced by one
    persistent [B, n, L] fp32 `cost_eff` buffer each; `plan` is the batched
    oracle's plan over them (`plan_batched`: the solo grid with B lanes and a
    fixed-point shift per lane; None on the CPU).  `inv_tau` [B, 1, 1] holds
    each lane's fp32(1/tau_b), the value the solo step reads into a Python
    float (`_inv_tau`) and the oracle's gamma_b."""

    costs: tuple[torch.Tensor, ...]  # c per bucket, [B, n, L] fp32
    slabs: tuple[kdo.Slab, ...]  # stacked idx, coeff and mask, cost = the cost_eff buffer
    scratch: torch.Tensor  # flat fp32: x * inv_tau of one bucket (all lanes) at a time
    inv_tau: torch.Tensor  # [B, 1, 1] fp32
    num_destinations: int
    radius: float
    inequality: bool
    plan: Optional[kdo.SlabPlan]

    @property
    def launches_per_call(self) -> int:
        """Oracle launches of one call on the card (0 on the CPU), whatever B."""
        return 0 if self.plan is None else len(self.plan.launches)

    def write_cost_eff(self, x_slabs) -> None:
        """Each bucket's buffer = c - x * inv_tau_b, in place: one product and
        one difference per bucket over all lanes, each rounded (a [B, 1, 1]
        factor multiplies as the solo step's Python float does)."""
        for c, x, s in zip(self.costs, x_slabs, self.slabs):
            _write_cost_eff(c, x, self.inv_tau, self.scratch[:x.numel()].view(x.shape), s.cost)


def plan_pdhg_step_batched(
    buckets,  # stacked fp32 compute views: [B, ...] tensors of one shape
    costs,  # the cost of each bucket, [B, n, L] fp32
    tau,  # each lane's primal step: B floats (or a [B] tensor, read once)
    *,
    num_destinations: int,
    radius: float = 1.0,
    inequality: bool = True,
) -> PDHGStepBatched:
    """Allocate the stacked `cost_eff` buffers of a batched solve, fix each
    lane's fp32(1/tau_b) and plan the batched oracle over the buffers (on the
    card; on the CPU there is no plan)."""
    taus = tau.tolist() if isinstance(tau, torch.Tensor) else list(tau)
    dev = costs[0].device
    inv = torch.tensor([_inv_tau(t) for t in taus], dtype=torch.float32)
    slabs = tuple(kdo.Slab(b.idx, b.coeff, torch.empty_like(c), b.mask)
                  for b, c in zip(buckets, costs))
    scratch = torch.empty(max(c.numel() for c in costs), dtype=torch.float32, device=dev)
    plan = plan_batched_oracle(slabs, num_destinations, radius=radius, inequality=inequality)
    return PDHGStepBatched(tuple(costs), slabs, scratch, inv.view(-1, 1, 1).to(dev),
                           num_destinations, float(radius), bool(inequality), plan)


def fused_pdhg_step_batched_call(
    step: PDHGStepBatched,
    x_slabs,  # [B, n, L] fp32 per bucket: the current primal of every lane
    y: torch.Tensor,  # [B, m * J] fp32 current duals
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """The PDHG prox step of every bucket of every lane: `(x_new slabs
    [B, n, L], A x_new [B, m*J])`, lane b bitwise its solo
    `fused_pdhg_step_call` at tau_b.

    Writes each bucket's `cost_eff = c - x * fp32(1/tau_b)` into the step's
    buffers, then makes ONE batched oracle call with gamma_b = fp32(1/tau_b)
    per lane: on the card one oracle launch for every lane and bucket of
    width <= 32 and one finalize, whatever B; on the CPU the plain call,
    lane by lane."""
    step.write_cost_eff(x_slabs)
    xs, ax, _, _ = fused_dual_oracle_batched_call(
        step.slabs, y, step.inv_tau.view(-1), num_destinations=step.num_destinations,
        radius=step.radius, inequality=step.inequality, plan=step.plan)
    return xs, ax
