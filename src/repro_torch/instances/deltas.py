"""Delta ingestion for recurring solves: O(delta) updates on bucketed-ELL slabs
(port of `repro.instances.deltas`).

The paper's workload is "solved repeatedly on recurring cadences over slowly
evolving inputs": day-over-day the eligibility graph gains/loses a small set
of edges and costs/budgets shift, while most nonzeros are unchanged.

`DeltaIngestor` keeps the packed `BucketedInstance` as the mutable source of
truth and applies an `InstanceDelta` *in place* on the slabs:

  * cost / coefficient updates overwrite the edge's slot;
  * deletions swap the row's last active slot into the hole (active slots of a
    row stay contiguous in ``[0, degree)``, the invariant `bucketize`
    establishes);
  * insertions fill the row's padding headroom (slab width L >= degree);
  * a source whose new degree outgrows its slab width is *moved* to a
    wider bucket's free (padded) row — row headroom can be reserved at build
    time via ``row_headroom``;
  * RHS updates replace the budget vector.

Every in-place path preserves slab shapes exactly.  Only when a bucket runs
out of headroom (or a degree exceeds the widest bucket) does the ingestor
fall back to a full re-bucketize, and it says so.  Padding stays exact-zero
everywhere (mask 0, coeff 0).

Host slabs.  The slabs are CPU tensors of the port's `BucketedInstance`,
and the ingestor edits them through numpy views that share their memory,
so its logic is the reference's numpy code step for step.  numpy has no
bfloat16: a bf16 slab is viewed as its int16 bit patterns, which moves and
zeroes copy exactly; new values are rounded to bf16 by torch (nearest even,
as the reference's `ml_dtypes` rounds them) and values read back are
widened exactly (`_SlabCodec`).

Invariants the service layer builds on (as in the reference):

  * **Scatter-plan emission** — every in-place `apply` also returns a compact
    `ScatterPlan` (`DeltaReport.plan`): the touched (bucket, row, slot) cells
    plus their post-delta values, gathered from the mutated host slabs as
    CPU tensors in the slab dtype.  Replaying it on any copy of the
    pre-delta slabs (`repro_torch.service.engine.apply_scatter_plan`)
    reproduces the post-delta slabs bit for bit.  Plan size is O(delta).
    The re-bucketize fallback emits no plan (`plan=None`): re-upload.
  * **Generation counter** — `generation` increments once per successful
    `apply`, and each plan is stamped with the generation it produces.
  * **Atomicity** — validation completes before the first mutation, so a
    rejected delta raises without touching the slabs, the occupancy maps,
    the drift accounting or the generation counter.
  * **Headroom-overflow fallback** — `DeltaReport.rebucketized`,
    `fallback_reason` and `shapes_changed` describe it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.instances.buckets import (
    Bucket,
    BucketedInstance,
    _host,
    bucketize,
    pack_source_ids,
    resolve_slab_dtype,
    slab_dtype_name,
)
from repro_torch.instances.generator import EdgeListInstance, MatchingInstanceSpec

__all__ = [
    "InstanceDelta",
    "DeltaReport",
    "BucketScatter",
    "ScatterPlan",
    "DeltaIngestor",
    "apply_delta_to_edge_list",
]


def _slots_of(d: np.ndarray) -> np.ndarray:
    """Slot offsets 0..d_i-1 of every row, concatenated (rows of d_i slots):
    `np.concatenate([np.arange(k) for k in d])` without a Python loop."""
    d = np.asarray(d, np.int64)
    return np.arange(int(d.sum()), dtype=np.int64) - np.repeat(np.cumsum(d) - d, d)


# Cells a bucket's gather in `DeltaIngestor._locate` holds at once.
_LOCATE_CELLS = 1 << 22


def _as_1d(a, dtype) -> np.ndarray:
    out = np.asarray([] if a is None else a, dtype=dtype)
    return out.reshape(-1)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class InstanceDelta:
    """A batch of edits to a matching LP between two cadences (host numpy).

    Edge edits are addressed by (source, destination) pairs; ``values`` follow
    the generator convention (positive matched value, the solver minimises
    ``cost = -value``).  ``insert_coeff``/``update_coeff`` have shape
    ``[m, k]`` (one row per coupling family).  ``rhs`` replaces the full
    ``[m * J]`` budget vector when given.
    """

    insert_src: np.ndarray = None
    insert_dst: np.ndarray = None
    insert_values: np.ndarray = None
    insert_coeff: np.ndarray = None  # [m, k_ins]
    delete_src: np.ndarray = None
    delete_dst: np.ndarray = None
    update_src: np.ndarray = None
    update_dst: np.ndarray = None
    update_values: Optional[np.ndarray] = None  # None: keep values
    update_coeff: Optional[np.ndarray] = None  # [m, k_upd]; None: keep coeff
    rhs: Optional[np.ndarray] = None  # [m * J] replacement

    def __post_init__(self):
        s = object.__setattr__
        s(self, "insert_src", _as_1d(self.insert_src, np.int64))
        s(self, "insert_dst", _as_1d(self.insert_dst, np.int64))
        s(self, "insert_values", _as_1d(self.insert_values, np.float64))
        coeff = self.insert_coeff
        if coeff is None:
            coeff = np.zeros((0, self.insert_src.size), np.float64)
        s(self, "insert_coeff", np.atleast_2d(np.asarray(coeff, np.float64)))
        s(self, "delete_src", _as_1d(self.delete_src, np.int64))
        s(self, "delete_dst", _as_1d(self.delete_dst, np.int64))
        s(self, "update_src", _as_1d(self.update_src, np.int64))
        s(self, "update_dst", _as_1d(self.update_dst, np.int64))
        if self.update_values is not None:
            s(self, "update_values", _as_1d(self.update_values, np.float64))
        if self.update_coeff is not None:
            s(self, "update_coeff",
              np.atleast_2d(np.asarray(self.update_coeff, np.float64)))
        if self.rhs is not None:
            s(self, "rhs", _as_1d(self.rhs, np.float64))
        if self.insert_src.size != self.insert_dst.size:
            raise ValueError("insert_src/insert_dst size mismatch")
        if self.insert_src.size != self.insert_values.size:
            raise ValueError("insert_values size mismatch")
        if self.insert_src.size and self.insert_coeff.shape[1] != self.insert_src.size:
            raise ValueError("insert_coeff must be [m, k_ins]")
        if self.delete_src.size != self.delete_dst.size:
            raise ValueError("delete_src/delete_dst size mismatch")
        if self.update_src.size != self.update_dst.size:
            raise ValueError("update_src/update_dst size mismatch")
        if self.update_values is not None and self.update_values.size != self.update_src.size:
            raise ValueError("update_values size mismatch")
        if self.update_coeff is not None and self.update_coeff.shape[1] != self.update_src.size:
            raise ValueError("update_coeff must be [m, k_upd]")

    @property
    def num_edits(self) -> int:
        return int(
            self.insert_src.size + self.delete_src.size + self.update_src.size
        )

    @property
    def is_empty(self) -> bool:
        return self.num_edits == 0 and self.rhs is None


@dataclasses.dataclass(frozen=True)
class BucketScatter:
    """Touched cells of one bucket's slabs, with their post-delta values.

    Cell addresses are **run-length compacted**: a run is a maximal set of
    consecutive slots ``[run_slots[r], run_slots[r] + run_lengths[r])`` in
    row ``run_rows[r]``.  Row moves rewrite ``[0, d)`` of both rows, deletes
    touch ``{j, d-1}``, inserts append at ``d``, so high-degree sources
    compress from O(d) index pairs to O(1) run descriptors while the value
    payload stays per-cell.  The expanded views (`rows`/`slots`) are unique
    and sorted row-major, so a replay is deterministic; the device replay
    (`service.engine.apply_scatter_plan`) transfers only the runs + values
    and re-expands on the device.  Every field is a CPU tensor; the values
    carry the slab dtype.
    """

    bucket: int
    run_rows: torch.Tensor  # [R] int32 row of each run
    run_slots: torch.Tensor  # [R] int32 first slot of each run
    run_lengths: torch.Tensor  # [R] int32 cells in each run
    idx: torch.Tensor  # [k] int32 destination ids (run order)
    cost: torch.Tensor  # [k] slab dtype
    mask: torch.Tensor  # [k] slab dtype
    coeff: torch.Tensor  # [m, k] slab dtype

    @classmethod
    def from_cells(
        cls,
        bucket: int,
        rows: np.ndarray,
        slots: np.ndarray,
        idx: torch.Tensor,
        cost: torch.Tensor,
        mask: torch.Tensor,
        coeff: torch.Tensor,
    ) -> "BucketScatter":
        """Compact unique row-major-sorted (rows, slots) cells into runs."""
        rows = np.asarray(rows, np.int32)
        slots = np.asarray(slots, np.int32)
        if rows.size == 0:
            starts = np.zeros(0, bool)
        else:
            starts = np.empty(rows.size, bool)
            starts[0] = True
            starts[1:] = (rows[1:] != rows[:-1]) | (slots[1:] != slots[:-1] + 1)
        first = np.flatnonzero(starts)
        bounds = np.append(first, rows.size)
        return cls(
            bucket=bucket,
            run_rows=torch.from_numpy(rows[first]),
            run_slots=torch.from_numpy(slots[first]),
            run_lengths=torch.from_numpy(np.diff(bounds).astype(np.int32)),
            idx=idx,
            cost=cost,
            mask=mask,
            coeff=coeff,
        )

    @property
    def num_cells(self) -> int:
        return int(self.idx.numel())

    @property
    def num_runs(self) -> int:
        return int(self.run_rows.numel())

    @property
    def rows(self) -> torch.Tensor:
        """Expanded per-cell row addresses (host-side view of the runs)."""
        return torch.repeat_interleave(self.run_rows, self.run_lengths.long())

    @property
    def slots(self) -> torch.Tensor:
        """Expanded per-cell slot addresses (host-side view of the runs)."""
        lengths = self.run_lengths.long()
        run_of = torch.repeat_interleave(torch.arange(self.num_runs), lengths)
        starts = torch.cumsum(lengths, 0) - lengths
        k = torch.arange(self.num_cells)
        return (self.run_slots[run_of] + (k - starts[run_of])).to(torch.int32)

    @property
    def nbytes(self) -> int:
        """Bytes a consumer transfers to replay: run descriptors + values."""
        return int(sum(_nbytes(t) for t in (
            self.run_rows, self.run_slots, self.run_lengths, self.idx,
            self.cost, self.mask, self.coeff,
        )))


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """Compact O(delta) description of one applied in-place delta.

    Replaying ``ops`` (plus the optional ``rhs`` replacement) on a copy of the
    pre-delta slabs reproduces the ingestor's post-delta slabs bit for bit.
    ``generation`` is the ingestor generation the plan produces: apply it
    only to state at generation ``generation - 1``.
    """

    generation: int
    ops: tuple[BucketScatter, ...]
    rhs: Optional[torch.Tensor] = None  # full [m * J] replacement, fp32

    @property
    def num_cells(self) -> int:
        return sum(op.num_cells for op in self.ops)

    @property
    def num_runs(self) -> int:
        """Contiguous-slot runs across all ops (index overhead is O(runs))."""
        return sum(op.num_runs for op in self.ops)

    @property
    def nbytes(self) -> int:
        """Host→device bytes a consumer must transfer to replay this plan."""
        n = sum(op.nbytes for op in self.ops)
        if self.rhs is not None:
            n += _nbytes(self.rhs)
        return n


@dataclasses.dataclass(frozen=True)
class DeltaReport:
    """What a `DeltaIngestor.apply` call did."""

    in_place: bool  # True: slabs mutated, shapes untouched
    rebucketized: bool  # True: fell back to a full re-pack
    shapes_changed: bool  # only possible when rebucketized
    n_insert: int
    n_delete: int
    n_update: int
    rhs_updated: bool
    moved_rows: int  # sources relocated to a wider bucket
    fallback_reason: Optional[str] = None
    # In-place applies carry the device-replayable scatter plan; the
    # re-bucketize fallback emits None (consumers must re-upload the slabs).
    plan: Optional[ScatterPlan] = None
    generation: int = 0  # ingestor generation after this apply


@dataclasses.dataclass
class _HostSlabs:
    """numpy views sharing memory with one bucket's CPU tensors (a bf16 slab
    as its int16 bit patterns)."""

    idx: np.ndarray
    coeff: np.ndarray
    cost: np.ndarray
    mask: np.ndarray


class _SlabCodec:
    """Between slab storage (the numpy views) and values: identity for fp32
    (numpy rounds float64 to fp32 on assignment, as the reference's fp32
    slabs do); bf16 bit patterns for bf16."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.bf16 = dtype == torch.bfloat16

    def view(self, t: torch.Tensor) -> np.ndarray:
        """The numpy view of a CPU slab tensor (shares its memory)."""
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        """A slab-dtype tensor of storage array `a` (copied)."""
        t = torch.from_numpy(np.array(a, copy=True))
        return t.view(torch.bfloat16) if self.bf16 else t

    def enc(self, v):
        """Values (float64) in storage form, rounded to the slab dtype."""
        if not self.bf16:
            return v
        t = torch.from_numpy(np.asarray(v, np.float64).copy())
        return t.to(torch.bfloat16).view(torch.int16).numpy()

    def dec(self, a) -> np.ndarray:
        """Stored cells as fp32 values (exact)."""
        if not self.bf16:
            return np.asarray(a)
        bits = np.asarray(a).view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)


def _slab_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of a state_dict slab array: the port's int16 bit patterns
    or the reference's bfloat16 arrays for bf16 (reinterpreted), else as is."""
    a = np.asarray(a)
    if dtype == torch.bfloat16:
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _pad_rows(t: torch.Tensor, extra: int, dim: int) -> torch.Tensor:
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


class DeltaIngestor:
    """Owns the mutable packed instance of one tenant and applies deltas.

    The packed slabs (CPU tensors, edited through numpy views) are the
    source of truth; the original edge list is only reconstructed on demand
    (``to_edge_list``) or when an overflow forces the re-bucketize fallback.
    ``row_headroom`` reserves that many extra all-padding rows per bucket at
    build time so that new sources and bucket promotions can be absorbed in
    place.
    """

    def __init__(
        self,
        inst: EdgeListInstance,
        *,
        shard_multiple: int = 1,
        min_length: int = 1,
        row_headroom: int = 0,
        dtype="float32",
    ):
        self.spec: MatchingInstanceSpec = inst.spec
        self.shard_multiple = int(shard_multiple)
        self.min_length = int(min_length)
        self.row_headroom = int(row_headroom)
        self.dtype = resolve_slab_dtype(dtype)
        if self.dtype == torch.int8:
            # In-place slab surgery on quantised cells is unsound: a delta's
            # new coefficient can exceed the bucket's frozen per-family scale,
            # and rescaling would rewrite every cell (O(nnz), defeating the
            # O(delta) ScatterPlan contract).
            raise ValueError(
                "DeltaIngestor does not support int8 slabs; use float32 or "
                "bfloat16"
            )
        self._codec = _SlabCodec(self.dtype)
        # Label for this ingestor's telemetry series ("" keeps standalone
        # ingestors unlabelled).
        self.telemetry_tenant = ""
        self._rhs64 = np.asarray(inst.rhs, np.float64).copy()
        # ||Delta c||^2 accumulated since the last drain — feeds the paper's
        # gamma drift bound (core.stability.drift_bound).
        self._pending_dc_sq = 0.0
        # Bumped once per successful apply(); plans are stamped with it.
        self.generation = 0
        # During apply(): per bucket, arrays of touched cells (row * L + slot),
        # turned into the ScatterPlan once the mutation completes.  None
        # outside.
        self._touched: Optional[dict[int, list[np.ndarray]]] = None
        self._build(inst)

    # -- construction -------------------------------------------------------

    def _rhs_tensor(self) -> torch.Tensor:
        return torch.from_numpy(self._rhs64.astype(np.float32))

    def _set_buckets(self, buckets: list[Bucket]) -> None:
        self.packed = BucketedInstance(
            buckets=tuple(buckets),
            rhs=self._rhs_tensor(),
            num_sources=self.spec.num_sources,
            num_destinations=self.spec.num_destinations,
            num_families=self.spec.num_families,
        )
        v = self._codec.view
        self._slabs = [
            _HostSlabs(idx=v(b.idx), coeff=v(b.coeff), cost=v(b.cost), mask=v(b.mask))
            for b in buckets
        ]
        self._lengths = [b.length for b in buckets]

    def _build(self, inst: EdgeListInstance) -> None:
        packed = bucketize(
            inst,
            shard_multiple=self.shard_multiple,
            min_length=self.min_length,
            dtype=self.dtype,
            device="cpu",
        )
        source_ids = pack_source_ids(packed)
        I = self.spec.num_sources
        buckets = []
        sids = []
        extra = self.row_headroom
        if extra:
            extra = -(-extra // self.shard_multiple) * self.shard_multiple
        for b, sid in zip(packed.buckets, source_ids):
            # own, writable copies
            idx, coeff, cost, mask = (t.clone() for t in (b.idx, b.coeff, b.cost, b.mask))
            if extra:
                idx = _pad_rows(idx, extra, 0)
                coeff = _pad_rows(coeff, extra, 1)
                cost = _pad_rows(cost, extra, 0)
                mask = _pad_rows(mask, extra, 0)
                sid = np.concatenate([sid, np.full(extra, -1, np.int64)])
            buckets.append(
                Bucket(idx=idx, coeff=coeff, cost=cost, mask=mask, length=b.length)
            )
            sids.append(np.asarray(sid, np.int64))
        self._set_buckets(buckets)
        self._source_ids = sids
        self.deg = np.bincount(inst.src, minlength=I).astype(np.int64)
        self.bucket_of = np.full(I, -1, np.int64)
        self.row_of = np.full(I, -1, np.int64)
        self._free_rows: list[list[int]] = []
        for t, sid in enumerate(sids):
            occupied = sid >= 0
            self.bucket_of[sid[occupied]] = t
            self.row_of[sid[occupied]] = np.flatnonzero(occupied)
            self._free_rows.append(list(np.flatnonzero(~occupied)[::-1]))

    # -- views ---------------------------------------------------------------

    def instance(self) -> BucketedInstance:
        """The current packed instance (live view; do not mutate externally)."""
        return self.packed

    @property
    def nnz(self) -> int:
        return int(self.deg.sum())

    def headroom(self) -> list[int]:
        """Free (all-padding) rows per bucket."""
        return [len(fr) for fr in self._free_rows]

    def drain_cost_drift(self) -> float:
        """||Delta c||_2 accumulated since the last drain (then reset)."""
        out = float(np.sqrt(self._pending_dc_sq))
        self._pending_dc_sq = 0.0
        return out

    def primal_unpacker(self):
        """Freeze the CURRENT occupancy maps into an `x_slabs -> (keys, x)` fn.

        The returned closure owns copies of the slot coordinates and edge
        keys, so it stays correct for primal slabs solved against *this*
        generation's layout even after later deltas mutate the maps (or a
        fallback re-shapes the slabs).  It takes tensors on any device.
        """
        J = self.spec.num_destinations
        per_bucket: list[tuple[int, np.ndarray, np.ndarray]] = []
        keys = []
        for t, b in enumerate(self._slabs):
            sid = self._source_ids[t]
            rows = np.flatnonzero(sid >= 0)
            if rows.size == 0:
                continue
            d = self.deg[sid[rows]]
            live = d > 0
            rows, d = rows[live], d[live]
            if rows.size == 0:
                continue
            r = np.repeat(rows, d)
            o = _slots_of(d)
            per_bucket.append((t, r, o))
            keys.append(
                np.repeat(sid[rows], d) * J + b.idx[r, o].astype(np.int64)
            )
        k = np.concatenate(keys) if keys else np.zeros(0, np.int64)
        order = np.argsort(k)
        k_sorted = k[order]

        def unpack(x_slabs: Sequence) -> tuple[np.ndarray, np.ndarray]:
            vals = [
                _host(x_slabs[t])[r, o].astype(np.float64)
                for t, r, o in per_bucket
            ]
            v = np.concatenate(vals) if vals else np.zeros(0)
            return k_sorted, v[order]

        return unpack

    def unpack_primal(self, x_slabs: Sequence) -> tuple[np.ndarray, np.ndarray]:
        """Primal slab values keyed by edge: `(keys, x)`, keys sorted.

        ``keys[e] = src * J + dst``.  Unlike slab-position comparisons, this
        keying survives row relocations and re-bucketizes.
        """
        return self.primal_unpacker()(x_slabs)

    def to_edge_list(self) -> EdgeListInstance:
        """Reconstruct the current state as a sorted edge list (O(nnz))."""
        srcs, dsts, vals, coeffs = [], [], [], []
        m = self.packed.num_families
        dec = self._codec.dec
        for t, b in enumerate(self._slabs):
            sid = self._source_ids[t]
            rows = np.flatnonzero(sid >= 0)
            if rows.size == 0:
                continue
            d = self.deg[sid[rows]]
            live = d > 0
            rows, d = rows[live], d[live]
            if rows.size == 0:
                continue
            r = np.repeat(rows, d)
            o = _slots_of(d)
            srcs.append(np.repeat(sid[rows], d))
            dsts.append(b.idx[r, o].astype(np.int64))
            vals.append(-dec(b.cost[r, o]).astype(np.float64))
            coeffs.append(dec(b.coeff[:, r, o]).astype(np.float64))
        src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
        dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
        values = np.concatenate(vals) if vals else np.zeros(0)
        coeff = (
            np.concatenate(coeffs, axis=1) if coeffs else np.zeros((m, 0))
        )
        order = np.lexsort((dst, src))
        return EdgeListInstance(
            spec=self.spec,
            src=src[order],
            dst=dst[order],
            values=values[order],
            coeff=coeff[:, order],
            rhs=self._rhs64.copy(),
        )

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> tuple[dict[str, np.ndarray], dict]:
        """(arrays, meta) capturing the exact packed state for checkpointing.

        `from_state` rebuilds an ingestor with identical slabs, occupancy maps,
        free-row stacks and generation — no re-bucketize, so row placement
        (and therefore all future scatter plans) matches bit for bit.
        ``arrays`` is flat str→ndarray (bf16 slabs as their int16 bit
        patterns); ``meta`` is JSON-able construction parameters.
        """
        arrays: dict[str, np.ndarray] = {
            "rhs64": self._rhs64.copy(),
            "deg": self.deg.copy(),
            "bucket_of": self.bucket_of.copy(),
            "row_of": self.row_of.copy(),
            "generation": np.asarray(self.generation, np.int64),
            "pending_dc_sq": np.asarray(self._pending_dc_sq, np.float64),
        }
        for t, b in enumerate(self._slabs):
            arrays[f"bucket{t}.idx"] = b.idx.copy()
            arrays[f"bucket{t}.coeff"] = b.coeff.copy()
            arrays[f"bucket{t}.cost"] = b.cost.copy()
            arrays[f"bucket{t}.mask"] = b.mask.copy()
            arrays[f"bucket{t}.source_ids"] = self._source_ids[t].copy()
            # free rows are a stack (pop/append order matters for future row
            # assignment), so persist the exact order, not just membership
            arrays[f"bucket{t}.free_rows"] = np.asarray(
                self._free_rows[t], np.int64
            )
        meta = {
            "spec": dataclasses.asdict(self.spec),
            "shard_multiple": self.shard_multiple,
            "min_length": self.min_length,
            "row_headroom": self.row_headroom,
            "dtype": slab_dtype_name(self.dtype),
            "lengths": [int(L) for L in self._lengths],
        }
        return arrays, meta

    @classmethod
    def from_state(
        cls, arrays: dict[str, np.ndarray], meta: dict
    ) -> "DeltaIngestor":
        """Rebuild an ingestor from `state_dict` output (exact restore)."""
        self = cls.__new__(cls)
        self.spec = MatchingInstanceSpec(**meta["spec"])
        self.shard_multiple = int(meta["shard_multiple"])
        self.min_length = int(meta["min_length"])
        self.row_headroom = int(meta["row_headroom"])
        self.dtype = resolve_slab_dtype(meta["dtype"])
        self._codec = _SlabCodec(self.dtype)
        self._rhs64 = np.asarray(arrays["rhs64"], np.float64).copy()
        self._pending_dc_sq = float(arrays["pending_dc_sq"])
        self.generation = int(arrays["generation"])
        self._touched = None
        self.telemetry_tenant = ""
        lengths = [int(L) for L in meta["lengths"]]
        buckets, sids, free = [], [], []
        for t, L in enumerate(lengths):
            slab = lambda k: _slab_tensor(arrays[f"bucket{t}.{k}"], self.dtype)
            buckets.append(
                Bucket(
                    idx=torch.from_numpy(np.asarray(arrays[f"bucket{t}.idx"]).copy()),
                    coeff=slab("coeff"),
                    cost=slab("cost"),
                    mask=slab("mask"),
                    length=L,
                )
            )
            sids.append(
                np.asarray(arrays[f"bucket{t}.source_ids"], np.int64).copy()
            )
            free.append(
                [int(r) for r in np.asarray(arrays[f"bucket{t}.free_rows"])]
            )
        self._set_buckets(buckets)
        self._source_ids = sids
        self.deg = np.asarray(arrays["deg"], np.int64).copy()
        self.bucket_of = np.asarray(arrays["bucket_of"], np.int64).copy()
        self.row_of = np.asarray(arrays["row_of"], np.int64).copy()
        self._free_rows = free
        return self

    # -- the delta path ------------------------------------------------------

    def apply(self, delta: InstanceDelta) -> DeltaReport:
        """Apply one delta; in place when headroom allows, else re-bucketize.

        Validation is complete before the first mutation (`_validate` +
        `_precheck` + move planning), so a rejected delta raises without
        touching the slabs, the occupancy maps, the drift accounting, or the
        generation counter.  In-place applies return a `DeltaReport` whose
        ``plan`` replays the exact slab edits on any copy of the pre-delta
        slabs (see `ScatterPlan`).
        """
        reg = telemetry.get_registry()
        tenant = self.telemetry_tenant
        try:
            report = self._apply(delta)
        except (ValueError, KeyError):
            reg.inc("delta_rejections_total", 1, tenant=tenant)
            raise
        path = "in_place" if report.in_place else "rebucketize"
        reg.inc("deltas_applied_total", 1, tenant=tenant, path=path)
        if report.n_insert:
            reg.inc("delta_edits_total", report.n_insert, op="insert")
        if report.n_delete:
            reg.inc("delta_edits_total", report.n_delete, op="delete")
        if report.n_update:
            reg.inc("delta_edits_total", report.n_update, op="update")
        if report.rebucketized:
            reg.inc("delta_rebucketize_total", 1, tenant=tenant)
        if report.plan is not None:
            reg.inc(
                "scatter_bytes_total", report.plan.nbytes, tenant=tenant
            )
            reg.inc(
                "scatter_cells_total", report.plan.num_cells, tenant=tenant
            )
        if report.moved_rows:
            reg.inc("delta_moved_rows_total", report.moved_rows, tenant=tenant)
        return report

    def _apply(self, delta: InstanceDelta) -> DeltaReport:
        with telemetry.span("delta_validate"):
            self._validate(delta)
            self._precheck(delta)
            plan_or_reason = self._plan_moves(delta)
        if isinstance(plan_or_reason, str):
            with telemetry.span("delta_rebucketize"):
                return self._fallback(delta, plan_or_reason)
        moves, to_free = plan_or_reason

        self._touched = {}
        try:
            with telemetry.span("delta_edits"):
                # 1. deletions (rows stay owned even at transient degree 0, so a
                #    delete-all-then-reinsert delta keeps the source's row)
                for s, d in zip(delta.delete_src, delta.delete_dst):
                    self._delete_edge(int(s), int(d))
                # 2. release rows of sources whose *final* degree is 0
                #    (planner-known), making them available to the relocation pass
                for s in to_free:
                    self._release_row(s)
                # 3. row relocations / allocations for grown sources
                for s, t_new in moves:
                    self._move_row(s, t_new)
                # 4. insertions into (now sufficient) row headroom
                for j, (s, d) in enumerate(zip(delta.insert_src, delta.insert_dst)):
                    self._insert_edge(
                        int(s), int(d),
                        float(delta.insert_values[j]), delta.insert_coeff[:, j],
                    )
                # 5. cost/coefficient updates
                self._update_edges(delta)
                # 6. budgets
                if delta.rhs is not None:
                    self._rhs64[:] = delta.rhs
                    self.packed.rhs = self._rhs_tensor()
                self.generation += 1
            with telemetry.span("delta_plan"):
                plan = self._emit_plan(rhs_updated=delta.rhs is not None)
        finally:
            self._touched = None
        return DeltaReport(
            in_place=True,
            rebucketized=False,
            shapes_changed=False,
            n_insert=int(delta.insert_src.size),
            n_delete=int(delta.delete_src.size),
            n_update=int(delta.update_src.size),
            rhs_updated=delta.rhs is not None,
            moved_rows=len(moves),
            plan=plan,
            generation=self.generation,
        )

    def _record(self, t: int, rows, slots) -> None:
        """Mark slab cells of bucket t as touched (all four arrays there);
        `rows` and `slots` broadcast against each other."""
        if self._touched is not None:
            cells = np.asarray(rows, np.int64) * self._lengths[t] + np.asarray(slots)
            self._touched.setdefault(t, []).append(cells.reshape(-1))

    def _emit_plan(self, *, rhs_updated: bool) -> ScatterPlan:
        """Gather post-delta values at the touched cells into a ScatterPlan."""
        ops = []
        slab = self._codec.tensor
        for t in sorted(self._touched or ()):
            # unique cells, row-major: row * L + slot sorts as (row, slot)
            cells = np.unique(np.concatenate(self._touched[t]))
            if not cells.size:
                continue
            b = self._slabs[t]
            L = self._lengths[t]
            rows = (cells // L).astype(np.int32)
            slots = (cells % L).astype(np.int32)
            ops.append(
                BucketScatter.from_cells(
                    bucket=t,
                    rows=rows,
                    slots=slots,
                    idx=torch.from_numpy(b.idx[rows, slots].copy()),
                    cost=slab(b.cost[rows, slots]),
                    mask=slab(b.mask[rows, slots]),
                    coeff=slab(b.coeff[:, rows, slots]),
                )
            )
        return ScatterPlan(
            generation=self.generation,
            ops=tuple(ops),
            rhs=self.packed.rhs.clone() if rhs_updated else None,
        )

    def _validate(self, delta: InstanceDelta) -> None:
        I, J, m = (
            self.spec.num_sources,
            self.spec.num_destinations,
            self.spec.num_families,
        )
        for name in ("insert", "delete", "update"):
            src = getattr(delta, f"{name}_src")
            dst = getattr(delta, f"{name}_dst")
            if src.size and (src.min() < 0 or src.max() >= I):
                raise ValueError(f"{name}_src out of range [0, {I})")
            if dst.size and (dst.min() < 0 or dst.max() >= J):
                raise ValueError(f"{name}_dst out of range [0, {J})")
        if delta.insert_src.size and delta.insert_coeff.shape[0] != m:
            raise ValueError(f"insert_coeff must have {m} families")
        if delta.update_coeff is not None and delta.update_coeff.shape[0] != m:
            raise ValueError(f"update_coeff must have {m} families")
        if delta.rhs is not None and delta.rhs.size != m * J:
            raise ValueError(f"rhs must have {m * J} entries")

    def _edge_exists(self, s: int, d: int) -> bool:
        t = int(self.bucket_of[s])
        if t < 0:
            return False
        b = self._slabs[t]
        dd = int(self.deg[s])
        return dd > 0 and bool(np.any(b.idx[int(self.row_of[s]), :dd] == d))

    def _locate(self, src: np.ndarray, dst: np.ndarray):
        """Slab cells of the edges (src, dst): arrays (bucket, row, slot,
        found), one entry per edge.  ``found`` is False where the source has
        no row or its active slots lack the destination; bucket and row are
        then the source's (-1 without a row) and slot is 0."""
        t, r, dg = self.bucket_of[src], self.row_of[src], self.deg[src]
        slot = np.zeros(src.size, np.int64)
        found = np.zeros(src.size, bool)
        for b in np.unique(t[t >= 0]).tolist():
            sel = np.flatnonzero(t == b)
            L = self._lengths[b]
            live = np.arange(L)
            step = max(1, _LOCATE_CELLS // L)
            for lo in range(0, sel.size, step):
                e = sel[lo:lo + step]
                hit = (self._slabs[b].idx[r[e]] == dst[e, None]) & (live < dg[e, None])
                slot[e] = hit.argmax(1)
                found[e] = hit.any(1)
        return t, r, slot, found

    def _precheck(self, delta: InstanceDelta) -> None:
        """Reject bad edits BEFORE any mutation, keeping `apply` atomic.

        Semantics mirror the apply order (deletes, inserts, updates): an
        insert may re-create an edge deleted by the same delta, and an
        update may target an edge inserted by the same delta.  Deletes and
        inserts are checked one by one, updates as arrays; either way the
        error names the first offending edit in delta order.
        """
        J = self.spec.num_destinations
        deleted: set = set()
        for s, d in zip(delta.delete_src, delta.delete_dst):
            key = int(s) * J + int(d)
            if key in deleted:
                raise KeyError(f"delete: duplicate edge ({s}, {d}) in delta")
            if not self._edge_exists(int(s), int(d)):
                raise KeyError(f"delete: edge ({s}, {d}) not present")
            deleted.add(key)
        inserted: set = set()
        for s, d in zip(delta.insert_src, delta.insert_dst):
            key = int(s) * J + int(d)
            if key in inserted:
                raise KeyError(f"insert: duplicate edge ({s}, {d}) in delta")
            if key not in deleted and self._edge_exists(int(s), int(d)):
                raise KeyError(f"insert: edge ({s}, {d}) already present")
            inserted.add(key)
        src, dst = delta.update_src, delta.update_dst
        if not src.size:
            return
        key = src * J + dst
        # duplicates would make drift accounting order-dependent (and
        # diverge between the in-place and fallback paths)
        dup = np.ones(key.size, bool)
        dup[np.unique(key, return_index=True)[1]] = False
        alive = np.isin(key, delta.insert_src * J + delta.insert_dst) | (
            ~np.isin(key, delta.delete_src * J + delta.delete_dst)
            & self._locate(src, dst)[3]
        )
        bad = np.flatnonzero(dup | ~alive)
        if bad.size:
            e = bad[0]
            if dup[e]:
                raise KeyError(f"update: duplicate edge ({src[e]}, {dst[e]}) in delta")
            raise KeyError(f"update: edge ({src[e]}, {dst[e]}) not present")

    def _plan_moves(self, delta: InstanceDelta):
        """Per-source final degrees -> list of (source, target_bucket) moves.

        Returns a fallback-reason string when the delta cannot be absorbed in
        place (degree beyond the widest bucket, or not enough free rows).
        """
        net: dict[int, int] = {}
        for s in delta.insert_src:
            net[int(s)] = net.get(int(s), 0) + 1
        for s in delta.delete_src:
            net[int(s)] = net.get(int(s), 0) - 1
        lengths = self._lengths
        moves: list[tuple[int, int]] = []
        to_free: list[int] = []
        free = [len(fr) for fr in self._free_rows]
        for s, dd in net.items():
            d_new = int(self.deg[s]) + dd
            if d_new < 0:
                raise ValueError(f"source {s}: more deletions than edges")
            if d_new == 0:
                t = int(self.bucket_of[s])
                if t >= 0:
                    free[t] += 1  # released before the relocation pass
                    to_free.append(s)
                continue
            if d_new > lengths[-1]:
                return (
                    f"source {s} degree {d_new} exceeds widest bucket "
                    f"L={lengths[-1]}"
                )
            t_cur = int(self.bucket_of[s])
            if t_cur >= 0 and d_new <= lengths[t_cur]:
                continue  # fits where it is
            t_new = int(np.searchsorted(lengths, d_new))
            moves.append((s, t_new))
        # Greedy feasibility, widest target first: rows vacated by a move are
        # in narrower buckets and so can host later (narrower-target) moves.
        moves.sort(key=lambda st: -st[1])
        for s, t_new in moves:
            if free[t_new] == 0:
                return f"bucket L={lengths[t_new]} has no free rows"
            free[t_new] -= 1
            t_cur = int(self.bucket_of[s])
            if t_cur >= 0:
                free[t_cur] += 1
        return moves, to_free

    def _fallback(self, delta: InstanceDelta, reason: str) -> DeltaReport:
        old_shapes = [(b.rows, b.length) for b in self.packed.buckets]
        cur = self.to_edge_list()
        # cost-drift bookkeeping (edge lists are (src, dst)-sorted, so the
        # (src*J + dst) key is sorted and searchsorted locates exact hits)
        J = self.spec.num_destinations
        key = cur.src * J + cur.dst
        dc_sq = float(np.sum(delta.insert_values**2))
        if delta.delete_src.size:
            pos = np.searchsorted(key, delta.delete_src * J + delta.delete_dst)
            pos = np.clip(pos, 0, key.size - 1)
            hit = key[pos] == delta.delete_src * J + delta.delete_dst
            dc_sq += float(np.sum(cur.values[pos[hit]] ** 2))
        if delta.update_src.size and delta.update_values is not None:
            pos = np.searchsorted(key, delta.update_src * J + delta.update_dst)
            pos = np.clip(pos, 0, key.size - 1)
            hit = key[pos] == delta.update_src * J + delta.update_dst
            dc_sq += float(
                np.sum((cur.values[pos[hit]] - delta.update_values[hit]) ** 2)
            )
        self._pending_dc_sq += dc_sq
        mutated = apply_delta_to_edge_list(cur, delta)
        self._rhs64 = np.asarray(mutated.rhs, np.float64).copy()
        self._build(mutated)
        self.generation += 1
        new_shapes = [(b.rows, b.length) for b in self.packed.buckets]
        return DeltaReport(
            in_place=False,
            rebucketized=True,
            shapes_changed=old_shapes != new_shapes,
            n_insert=int(delta.insert_src.size),
            n_delete=int(delta.delete_src.size),
            n_update=int(delta.update_src.size),
            rhs_updated=delta.rhs is not None,
            moved_rows=0,
            fallback_reason=reason,
            plan=None,
            generation=self.generation,
        )

    # -- slab surgery --------------------------------------------------------

    def _slot_of(self, s: int, d: int) -> tuple[int, int, int]:
        t = int(self.bucket_of[s])
        if t < 0:
            raise KeyError(f"source {s} has no edges")
        r = int(self.row_of[s])
        b = self._slabs[t]
        dd = int(self.deg[s])
        hits = np.flatnonzero(b.idx[r, :dd] == d)
        if hits.size == 0:
            raise KeyError(f"edge ({s}, {d}) not present")
        return t, r, int(hits[0])

    def _delete_edge(self, s: int, d: int) -> None:
        t, r, j = self._slot_of(s, d)
        b = self._slabs[t]
        self._pending_dc_sq += float(self._codec.dec(b.cost[r, j])) ** 2
        last = int(self.deg[s]) - 1
        for arr in (b.idx, b.cost, b.mask):
            arr[r, j] = arr[r, last]
            arr[r, last] = 0
        b.coeff[:, r, j] = b.coeff[:, r, last]
        b.coeff[:, r, last] = 0
        self.deg[s] = last
        self._record(t, r, np.array([j, last]))

    def _release_row(self, s: int) -> None:
        if self.deg[s] != 0:
            raise RuntimeError(f"releasing row of source {s} with edges left")
        t, r = int(self.bucket_of[s]), int(self.row_of[s])
        self._source_ids[t][r] = -1
        self._free_rows[t].append(r)
        self.bucket_of[s] = -1
        self.row_of[s] = -1

    def _insert_edge(self, s: int, d: int, value: float, coeff: np.ndarray) -> None:
        t = int(self.bucket_of[s])
        dd = int(self.deg[s])
        b = self._slabs[t]
        if dd and np.any(b.idx[int(self.row_of[s]), :dd] == d):
            raise KeyError(f"edge ({s}, {d}) already present")
        r = int(self.row_of[s])
        enc = self._codec.enc
        b.idx[r, dd] = d
        b.cost[r, dd] = enc(-value)
        b.mask[r, dd] = enc(1.0)
        b.coeff[:, r, dd] = enc(coeff)
        self.deg[s] = dd + 1
        self._pending_dc_sq += value**2
        self._record(t, r, dd)

    def _update_edges(self, delta: InstanceDelta) -> None:
        """Step 5 of `_apply`: every update at once, one scatter per bucket.

        Located after the deletes, moves and inserts, which shift slots and
        rows.  The drift gains ``(old value - new value)**2`` per update,
        added one term at a time in delta order, as a per-edit loop adds them.
        """
        src, dst = delta.update_src, delta.update_dst
        if not src.size:
            return
        t, r, j, found = self._locate(src, dst)
        if not found.all():
            raise RuntimeError("update of a missing edge passed the precheck")
        values, coeff = delta.update_values, delta.update_coeff
        enc, dec = self._codec.enc, self._codec.dec
        terms = np.empty(src.size)
        for b in np.unique(t).tolist():
            e = np.flatnonzero(t == b)
            slab = self._slabs[b]
            rows, slots = r[e], j[e]
            if values is not None:
                # float_power calls the C library's pow, as Python's `x ** 2`
                # does; `**` on an array squares, which rounds differently
                old = dec(slab.cost[rows, slots]).astype(np.float64)
                terms[e] = np.float_power(old + values[e], 2.0)
                slab.cost[rows, slots] = enc(-values[e])
            if coeff is not None:
                slab.coeff[:, rows, slots] = enc(coeff[:, e])
            self._record(b, rows, slots)
        if values is not None:
            # np.add.accumulate adds left to right (np.sum adds in pairs)
            acc = np.add.accumulate(np.concatenate([[self._pending_dc_sq], terms]))
            self._pending_dc_sq = float(acc[-1])

    def _move_row(self, s: int, t_new: int) -> None:
        """Relocate source s to a free row of bucket t_new (or claim one)."""
        if not self._free_rows[t_new]:
            raise RuntimeError("move planned without a free row (planner bug)")
        r_new = self._free_rows[t_new].pop()
        t_old = int(self.bucket_of[s])
        if t_old >= 0:
            r_old = int(self.row_of[s])
            bo, bn = self._slabs[t_old], self._slabs[t_new]
            d = int(self.deg[s])
            for src_arr, dst_arr in (
                (bo.idx, bn.idx), (bo.cost, bn.cost), (bo.mask, bn.mask),
            ):
                dst_arr[r_new, :d] = src_arr[r_old, :d]
                src_arr[r_old, :d] = 0
            bn.coeff[:, r_new, :d] = bo.coeff[:, r_old, :d]
            bo.coeff[:, r_old, :d] = 0
            self._record(t_old, r_old, np.arange(d))
            self._record(t_new, r_new, np.arange(d))
            self._source_ids[t_old][r_old] = -1
            self._free_rows[t_old].append(r_old)
        self._source_ids[t_new][r_new] = s
        self.bucket_of[s] = t_new
        self.row_of[s] = r_new


# ---------------------------------------------------------------------------


def apply_delta_to_edge_list(
    inst: EdgeListInstance, delta: InstanceDelta
) -> EdgeListInstance:
    """Reference (O(nnz)) application of a delta on the edge-list form.

    This is the slow path the ingestor falls back to, and the oracle the
    equivalence tests compare the in-place slab surgery against.  Edit order
    matches the in-place path: deletions, then insertions, then updates (so an
    update may target an edge inserted by the same delta).
    """
    J = inst.spec.num_destinations

    def locate(key_sorted, perm, src, dst, what):
        k = np.asarray(src) * J + np.asarray(dst)
        pos = np.searchsorted(key_sorted, k)
        ok = (pos < key_sorted.size) & (
            key_sorted[np.minimum(pos, key_sorted.size - 1)] == k
        )
        if not np.all(ok):
            missing = np.flatnonzero(~ok)[0]
            raise KeyError(
                f"{what}: edge ({src[missing]}, {dst[missing]}) not present"
            )
        return perm[pos]

    values = inst.values.copy()
    coeff = inst.coeff.copy()
    src, dst = inst.src.copy(), inst.dst.copy()

    if delta.delete_src.size:
        key = src * J + dst
        perm = np.argsort(key)
        e = locate(key[perm], perm, delta.delete_src, delta.delete_dst, "delete")
        keep = np.ones(src.size, bool)
        keep[e] = False
        src, dst, values, coeff = src[keep], dst[keep], values[keep], coeff[:, keep]

    if delta.insert_src.size:
        new_key = delta.insert_src * J + delta.insert_dst
        if np.intersect1d(new_key, src * J + dst).size:
            raise KeyError("insert: edge already present")
        if np.unique(new_key).size != new_key.size:
            raise KeyError("insert: duplicate edges in delta")
        src = np.concatenate([src, delta.insert_src])
        dst = np.concatenate([dst, delta.insert_dst])
        values = np.concatenate([values, delta.insert_values])
        coeff = np.concatenate([coeff, delta.insert_coeff], axis=1)

    if delta.update_src.size:
        key = src * J + dst
        perm = np.argsort(key)
        e = locate(key[perm], perm, delta.update_src, delta.update_dst, "update")
        if delta.update_values is not None:
            values[e] = delta.update_values
        if delta.update_coeff is not None:
            coeff[:, e] = delta.update_coeff

    order = np.lexsort((dst, src))
    rhs = inst.rhs.copy() if delta.rhs is None else np.asarray(delta.rhs, np.float64)
    return EdgeListInstance(
        spec=inst.spec,
        src=src[order],
        dst=dst[order],
        values=values[order],
        coeff=coeff[:, order],
        rhs=rhs,
    )
