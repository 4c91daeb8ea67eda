"""Low-latency allocation serving from device-resident duals (port of
`repro.serving.duals`).

Once a cadence solve has produced the duals ``lam``, one user's allocation

    x_u = Pi_C( -(A_u^T lam + c_u) / gamma )

is local and O(degree): no solve at request time.  This module is the
serving surface over that fact:

  * `DualSnapshot` — one immutable, generation-stamped publication: the
    descaled duals, the device-resident raw slabs they were solved over,
    the dispatch-time occupancy maps (user -> bucket/row) and, on the card,
    the event after which its tensors are ready.
  * `DualStore` — the per-tenant slot the service publishes into.  A publish
    swaps the slot reference under a lock; a query reads the slot ONCE and
    answers the whole batch against that snapshot.  Snapshots are never
    mutated (a scatter-plan replay builds new tensors for the buckets it
    touches), so a torn read cannot happen — this is the generation fence,
    and every `QueryResult` reports which generation it was served from.
  * the query: the primal step of the requested rows only, bit-identical to
    a post-hoc direct projection (`direct_allocations`, the unfused
    `MatchingObjective.primal_candidate` over the whole snapshot) against
    the same snapshot.  How, is decided once per snapshot by its
    formulation:
      - a simplex tenant (the matching formulation, unit term scales) is
        answered by kernel 2 over the requested rows
        (`kernels.ops.fused_dual_primal_rows`): on the card ONE launch for
        every requested bucket of width <= 32 (one more per wider bucket),
        from a plan built once per snapshot; on the CPU its plain version;
      - a tenant with another feasible set (capacity-cap, fairness-floor,
        budget-pacing) or non-unit term scales is answered by plain PyTorch
        ops over the gathered rows, which mirror `primal_candidate` op for op
        (the reference has no kernel for those sets either).

Threads and streams on the card: a query runs on the calling thread's
current stream (the serve launcher gives each hammer thread its own), which
first waits on the snapshot's `ready` event, recorded on the publishing
thread's stream after lam_eff was computed.  The snapshot holds every tensor
a query reads, and a query copies its answer to the host before it returns,
so no tensor is freed while another stream still reads it.

Scaled-dual subtlety: the service solves with device-side Jacobi
normalization (A' = D A), so the solver's duals live in the scaled space
and ``lam_original = D lam'``.  `compute_lam_eff` descales the duals ONCE
per publish — then ``A'^T lam' = A^T (D lam')`` lets the query gather the
raw slabs.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.objective import (
    MatchingObjective,
    gather_at_lam,
    inv_gamma,
    row_scales,
)
from repro_torch.core.projections import UnitSimplexProjection
from repro_torch.formulation.spec import lower_spec
from repro_torch.instances.buckets import BucketedInstance, dequantize_bucket

__all__ = [
    "BucketAllocations",
    "DualSnapshot",
    "DualStore",
    "QueryResult",
    "compute_lam_eff",
    "direct_allocations",
]


# -- publish-side math --------------------------------------------------------


def _descale_duals(inst: BucketedInstance, lam: torch.Tensor) -> torch.Tensor:
    """D lam' over the RAW slabs — the inverse of `normalize_rows_traced`:
    the same fp32 D (`row_scales`) the normalized solve applied on the
    device."""
    return lam * row_scales(inst)


def compute_lam_eff(
    instance: BucketedInstance, lam: torch.Tensor, *, normalize: bool
) -> torch.Tensor:
    """The duals a query gathers raw slabs against.

    ``normalize=True`` (the service default) maps the solver's scaled-space
    duals back to the original space on the device; ``normalize=False``
    solves were already in the original space.
    """
    if not normalize:
        return lam
    return _descale_duals(instance, lam)


def _lowered(inst: BucketedInstance):
    """(per-bucket projections, cost_scale, ridge_weight) of an instance.

    Same resolution as `MatchingObjective.__post_init__`: a spec-free
    instance is the simplex matching formulation.
    """
    spec = getattr(inst, "formulation", None)
    if spec is None:
        return (UnitSimplexProjection(),) * len(inst.buckets), 1.0, 1.0
    low = lower_spec(spec, inst)
    return low.projections, low.cost_scale, low.ridge_weight


def direct_allocations(snap: "DualSnapshot") -> tuple[torch.Tensor, ...]:
    """Post-hoc direct projection against one snapshot — full slabs.

    The reference a served batch is bit-compared against: the unfused
    `MatchingObjective.primal_candidate` over the snapshot's raw device
    instance and published (descaled) duals, at the snapshot's gamma floor
    (fp32 x for fp32 and bf16 slabs alike).
    """
    if snap.ready is not None:
        torch.cuda.current_stream(snap.lam_eff.device).wait_event(snap.ready)
    return MatchingObjective(snap.instance).primal_candidate(snap.lam_eff, snap.gamma)


# -- snapshots and results ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DualSnapshot:
    """One immutable publication: duals + the instance they were solved over.

    ``instance`` is the dispatch-time device-resident RAW instance (the
    in-flight solve's input, never the host slabs — the overlapped pipeline
    keeps mutating those), so slabs, maps and duals are mutually consistent
    at ``generation``.  ``lam_eff`` is already descaled (`compute_lam_eff`).
    ``ready`` is the CUDA event after which they may be read (None on the
    CPU).
    """

    tenant: str
    generation: int  # ingestor generation the instance reflects
    cadence: int  # session cadence that produced the duals
    gamma: float  # gamma floor the solve converged at
    lam_eff: torch.Tensor  # [dual_dim] original-space duals, device-resident
    instance: BucketedInstance  # raw device slabs (+ FormulationSpec, if any)
    bucket_of: np.ndarray  # [I] user -> bucket (-1: no edges)
    row_of: np.ndarray  # [I] user -> slab row
    deg: np.ndarray  # [I] user degree
    ready: Optional[Any] = None  # torch.cuda.Event on the card
    # how this snapshot is queried, decided once at first query
    _route: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def num_users(self) -> int:
        return int(self.bucket_of.shape[0])

    def query_route(self) -> dict:
        """The snapshot's query route, decided once: kernel 2 over the
        requested rows for a simplex tenant with unit term scales (with its
        row-list plan on the card), plain ops over the gathered rows for any
        other formulation."""
        with _ROUTE_LOCK:
            if not self._route:
                projections, cost_scale, ridge_weight = _lowered(self.instance)
                kernel = (len(set(projections)) == 1
                          and isinstance(projections[0], UnitSimplexProjection)
                          and not projections[0].use_kernel
                          and cost_scale == 1.0 and ridge_weight == 1.0)
                route = {"kernel": kernel, "projections": projections,
                         "cost_scale": cost_scale, "ridge_weight": ridge_weight,
                         "plan": None}
                if kernel:
                    from repro_torch.kernels import ops as kops

                    inst = self.instance
                    route["plan"] = kops.plan_rows(
                        inst.buckets, inst.num_destinations, radius=projections[0].radius,
                        inequality=projections[0].inequality)
                self._route.update(route)
        return self._route


_ROUTE_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class BucketAllocations:
    """Allocations of the queried users living in one bucket."""

    bucket: int
    users: np.ndarray  # [q] user ids, in query order within the bucket
    rows: np.ndarray  # [q] slab rows they were served from
    x: np.ndarray  # [q, L] allocations (padding slots are exact zeros)
    idx: np.ndarray  # [q, L] destination ids per slot
    mask: np.ndarray  # [q, L] slot validity


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One served batch — answered entirely against ``generation``."""

    tenant: str
    generation: int
    cadence: int
    gamma: float
    users: np.ndarray
    slabs: tuple[BucketAllocations, ...]
    unmatched: np.ndarray  # queried users with no edges at this generation
    latency_seconds: float

    @property
    def num_users(self) -> int:
        return int(self.users.size)

    def allocation(self, user: int) -> tuple[np.ndarray, np.ndarray]:
        """(destination ids, allocation values) of one queried user."""
        for ba in self.slabs:
            pos = np.flatnonzero(ba.users == user)
            if pos.size:
                p = int(pos[0])
                sel = ba.mask[p].astype(bool)
                return ba.idx[p][sel].astype(np.int64), ba.x[p][sel]
        return np.zeros(0, np.int64), np.zeros(0, np.float32)


def _plain_rows(inst, route, requests, lam, gamma):
    """The query of a tenant of another feasible set (or non-unit scales):
    `primal_candidate`'s ops, restricted to the requested rows of each
    bucket: gather, family sum, scaled cost, times 1/(ridge_weight*gamma),
    the bucket's projection."""
    m, J = inst.num_families, inst.num_destinations
    lam2 = lam.reshape(m, J)
    ginv = inv_gamma(gamma if route["ridge_weight"] == 1.0
                     else float(np.float32(route["ridge_weight"]) * np.float32(gamma)))
    out = []
    for t, rows in requests:
        b = dequantize_bucket(inst.buckets[t])
        r = torch.as_tensor(rows, device=b.idx.device)
        idx, mask, cost = b.idx[r], b.mask[r], b.cost[r]
        if route["cost_scale"] != 1.0:
            cost = route["cost_scale"] * cost
        v = -(gather_at_lam(b.coeff[:, r], idx, lam2) + cost) * ginv
        out.append((route["projections"][t](v, mask), mask, idx))
    return out


# -- the store ----------------------------------------------------------------


class DualStore:
    """Per-tenant slots of the latest published duals (atomic swap on publish).

    Thread-safety contract: `publish` replaces a slot reference under the
    store lock; `query` reads the slot once and then works exclusively off
    that immutable `DualSnapshot`.  A publish landing mid-query therefore
    never mixes generations within a batch.  ``history > 0`` additionally
    retains the last N snapshots per tenant (`get`), which is what the
    post-hoc bit-identity verification replays queries against.
    """

    def __init__(self, *, history: int = 0):
        self._lock = threading.Lock()
        self._latest: dict[str, DualSnapshot] = {}
        self._history: dict[str, deque] = {}
        self.history = int(history)

    # -- publish side --------------------------------------------------------

    def publish(self, snap: DualSnapshot) -> DualSnapshot:
        """Swap in a new snapshot for its tenant (the generation fence)."""
        with self._lock:
            self._latest[snap.tenant] = snap
            if self.history:
                self._history.setdefault(
                    snap.tenant, deque(maxlen=self.history)
                ).append(snap)
        reg = telemetry.get_registry()
        reg.inc("serving_publishes_total", 1, tenant=snap.tenant)
        reg.set_gauge("serving_generation", snap.generation, tenant=snap.tenant)
        return snap

    def publish_result(
        self,
        tenant: str,
        instance: BucketedInstance,
        lam: torch.Tensor,
        *,
        generation: int,
        gamma: float,
        bucket_of: np.ndarray,
        row_of: np.ndarray,
        deg: np.ndarray,
        cadence: int = 0,
        normalize: bool = True,
    ) -> DualSnapshot:
        """Build + publish a snapshot from an engine-level solve.

        The session/scheduler path publishes out of `SolveSession.absorb`;
        this helper serves callers that drive `compiled_solver` directly
        (tests, offline fits).  ``instance`` must be the RAW (unnormalized)
        instance the solve ran on; ``normalize`` says whether the solve
        scaled it on the device, i.e. whether ``lam`` needs descaling.
        """
        lam_eff = compute_lam_eff(instance, lam, normalize=normalize)
        ready = None
        if lam_eff.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(lam_eff.device))
        snap = DualSnapshot(
            tenant=tenant,
            generation=int(generation),
            cadence=int(cadence),
            gamma=float(gamma),
            lam_eff=lam_eff,
            instance=instance,
            bucket_of=np.asarray(bucket_of, np.int64).copy(),
            row_of=np.asarray(row_of, np.int64).copy(),
            deg=np.asarray(deg, np.int64).copy(),
            ready=ready,
        )
        return self.publish(snap)

    # -- read side -----------------------------------------------------------

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._latest)

    def snapshot(self, tenant: str) -> DualSnapshot:
        """The tenant's current snapshot (the single fenced read)."""
        with self._lock:
            try:
                return self._latest[tenant]
            except KeyError:
                raise KeyError(
                    f"no duals published for tenant {tenant!r} yet"
                ) from None

    def generations(self, tenant: str) -> list[int]:
        """Generations currently answerable via `get` (history + latest)."""
        with self._lock:
            gens = {s.generation for s in self._history.get(tenant, ())}
            if tenant in self._latest:
                gens.add(self._latest[tenant].generation)
        return sorted(gens)

    def get(self, tenant: str, generation: int) -> DualSnapshot:
        """A retained snapshot by generation (requires ``history > 0``)."""
        with self._lock:
            latest = self._latest.get(tenant)
            if latest is not None and latest.generation == generation:
                return latest
            for s in self._history.get(tenant, ()):
                if s.generation == generation:
                    return s
        raise KeyError(
            f"generation {generation} of tenant {tenant!r} is not retained "
            f"(history={self.history})"
        )

    def query(
        self, tenant: str, users: Sequence[int], *, block: bool = True
    ) -> QueryResult:
        """Answer one batch of allocation requests from the current snapshot.

        The snapshot reference is read exactly once, so the whole batch —
        across all buckets its users map to — is served against a single
        generation, reported in the result.  Users with no edges at that
        generation come back in ``unmatched`` with zero allocations.
        (``block`` is the reference's; the answer is always copied to the
        host, which waits for the device.)
        """
        t0 = time.perf_counter()
        snap = self.snapshot(tenant)
        return self.query_snapshot(snap, users, block=block, t0=t0)

    def query_snapshot(
        self,
        snap: DualSnapshot,
        users: Sequence[int],
        *,
        block: bool = True,
        t0: Optional[float] = None,
    ) -> QueryResult:
        """Serve a batch against an explicit snapshot (post-hoc replays)."""
        if t0 is None:
            t0 = time.perf_counter()
        users = np.asarray(users, np.int64).reshape(-1)
        if users.size and (
            users.min() < 0 or users.max() >= snap.num_users
        ):
            raise ValueError(
                f"user ids must be in [0, {snap.num_users}); got range "
                f"[{users.min()}, {users.max()}]"
            )
        b_of = snap.bucket_of[users]
        served = (b_of >= 0) & (snap.deg[users] > 0)
        unmatched = users[~served]
        inst = snap.instance
        route = snap.query_route()
        picks = []
        for t in np.unique(b_of[served]):
            pick = served & (b_of == t)
            picks.append((int(t), users[pick], snap.row_of[users[pick]]))
        requests = [(t, rows) for t, _, rows in picks]
        slabs = []
        if picks:
            if snap.ready is not None:
                torch.cuda.current_stream(snap.lam_eff.device).wait_event(snap.ready)
            if route["kernel"]:
                from repro_torch.kernels import ops as kops

                proj = route["projections"][0]
                outs = kops.fused_dual_primal_rows(
                    inst.buckets, requests, snap.lam_eff, snap.gamma,
                    num_destinations=inst.num_destinations, radius=proj.radius,
                    inequality=proj.inequality, plan=route["plan"])
            else:
                outs = _plain_rows(inst, route, requests, snap.lam_eff, snap.gamma)
            host = _to_host(outs)
            for (t, u, rows), (x, mask, idx) in zip(picks, host):
                slabs.append(BucketAllocations(bucket=t, users=u, rows=rows, x=x,
                                               idx=idx, mask=mask))
        dt = time.perf_counter() - t0
        reg = telemetry.get_registry()
        reg.inc("serving_queries_total", 1, tenant=snap.tenant)
        reg.inc("serving_users_total", int(users.size), tenant=snap.tenant)
        if unmatched.size:
            reg.inc(
                "serving_unmatched_total", int(unmatched.size),
                tenant=snap.tenant,
            )
        reg.observe("serving_query_seconds", dt, tenant=snap.tenant)
        return QueryResult(
            tenant=snap.tenant,
            generation=snap.generation,
            cadence=snap.cadence,
            gamma=snap.gamma,
            users=users,
            slabs=tuple(slabs),
            unmatched=unmatched,
            latency_seconds=dt,
        )


def _to_host(outs) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Each request's (x, mask, idx) as numpy arrays.  The kernel's outputs
    are views of one buffer on the card, so they come over in one copy."""
    if not outs:
        return []
    bases = {t.untyped_storage().data_ptr() for o in outs for t in o}
    if outs[0][0].device.type == "cuda" and len(bases) == 1:
        buf = outs[0][0]
        storage = torch.empty(0, dtype=torch.float32, device=buf.device).set_(
            buf.untyped_storage())
        host = storage.cpu()
        take = lambda t: (host[t.storage_offset():t.storage_offset() + t.numel()]
                          .view(t.dtype).reshape(t.shape).numpy())
        return [tuple(take(t) for t in o) for o in outs]
    return [tuple(t.detach().cpu().numpy() for t in o) for o in outs]
