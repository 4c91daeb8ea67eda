"""Solve engine of the recurring-solve path, single-tenant half (port of
`repro.service.engine`).

The full continuation solve is a function of the instance it is given:

    raw = _raw_solve(instance, lam0, cfg, normalize, fused_oracle, engine=...)

so slab updates between cadences are always seen: every call builds a fresh
objective, and with it fresh kernel plans (the oracle plan holds raw slab
pointers and a fixed-point scale fixed per objective), over the instance it
is passed.  Nothing of one solve is cached for the next.

Invariants:

  * **Solver caches** — `compiled_solver` / `compiled_solver_fixed_sigma`
    hold one entry point per `(MaximizerConfig, normalize, fused_oracle,
    engine)` key, as the reference's jit caches do.  Eager PyTorch compiles
    nothing, so a "compile" here is the first call of an entry point on an
    instance of new slab shapes and dtypes (the reference's XLA re-keys on
    shapes the same way); later calls on the same shapes are cache hits.
    The counters (`engine_compiles_total`, `engine_compile_seconds_total`,
    `engine_cache_hits_total`) and `compile_cache_report` keep the
    reference's names.  The first call's seconds are its host time, which
    ends before the device does.
  * **Device residency** — `device_put_instance` copies the packed slabs to
    the device once (O(nnz)); each cadence's `ScatterPlan` is then replayed
    with `apply_scatter_plan`, whose host→device traffic is the plan's run
    descriptors and values (O(delta)).  The plan's payload is the host
    slabs' own values, so the replayed device slabs equal the host slabs
    bit for bit.
  * **Asynchrony** — the entry points only enqueue device work; `RawSolve`
    holds device tensors.  Callers that time a solve end it with
    `torch.cuda.synchronize()`.

The batched half of the reference (`compiled_batch_solver*`,
`to_solve_results`) comes with the tenant pool.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import torch

from repro_torch import telemetry
from repro_torch.core.maximizer import MaximizerConfig, SolveResult
from repro_torch.device import resolve_device
from repro_torch.engines.base import RawSolve, resolve_engine
from repro_torch.instances.buckets import Bucket, BucketedInstance
from repro_torch.instances.deltas import BucketScatter, ScatterPlan

__all__ = [
    "RawSolve",
    "compiled_solver",
    "compiled_solver_fixed_sigma",
    "to_solve_result",
    "compile_cache_report",
    "device_put_instance",
    "apply_scatter_plan",
    "instance_nbytes",
]


def _raw_solve(
    inst: BucketedInstance,
    lam0: torch.Tensor,
    cfg: MaximizerConfig,
    normalize: bool,
    fused_oracle: bool = False,
    sigma_sq: Optional[torch.Tensor] = None,
    engine: str = "agd",
) -> RawSolve:
    """Full solve of `inst` from `lam0` on the named engine
    (`repro_torch.engines`): ``"agd"`` is the paper's continuation solve,
    ``"pdhg"`` the structured primal-dual engine.  Both share the RawSolve
    contract and the [m*J] dual space.

    ``sigma_sq=None`` runs the power iteration (`cfg.power_iters` steps of
    A A^T); a given estimate skips it (see `compiled_solver_fixed_sigma`).
    """
    return resolve_engine(engine).raw_solve(
        inst,
        lam0,
        cfg,
        normalize=normalize,
        fused_oracle=fused_oracle,
        sigma_sq=sigma_sq,
    )


# One entry point per (MaximizerConfig, normalize, fused_oracle, engine)
# tuple; each remembers the instance shape keys it has been called on.
_SINGLE: dict[tuple, object] = {}
_SINGLE_SIGMA: dict[tuple, object] = {}


def _leaves(inst: BucketedInstance) -> list[torch.Tensor]:
    """The instance's tensors: each bucket's slabs (and int8 scales), then
    the rhs."""
    out = []
    for b in inst.buckets:
        out += [t for t in (b.idx, b.coeff, b.cost, b.mask, b.coeff_scale, b.cost_scale)
                if t is not None]
    return out + [inst.rhs]


def _shape_key(inst: BucketedInstance) -> str:
    """Short stable digest of the instance's leaf shapes and dtypes — the
    solver caches' key, rendered as a telemetry label."""
    shapes = tuple((tuple(t.shape), str(t.dtype)) for t in _leaves(inst))
    return hashlib.md5(repr(shapes).encode()).hexdigest()[:10]


def _instrument(solve, entry: str):
    """Wrap an entry point with cache hit/first-call accounting: the first
    call on a new shape key is recorded as a compile (with its host
    seconds), every later one as a hit."""
    seen: set[str] = set()

    def wrapper(*args):
        reg = telemetry.get_registry()
        key = _shape_key(args[0])
        t0 = time.perf_counter()
        out = solve(*args)
        dt = time.perf_counter() - t0
        if key not in seen:
            seen.add(key)
            reg.inc("engine_compiles_total", 1, entry=entry)
            reg.inc("engine_compile_seconds_total", dt, entry=entry, shapes=key)
            reg.observe("engine_compile_seconds", dt, entry=entry)
        else:
            reg.inc("engine_cache_hits_total", 1, entry=entry)
        return out

    wrapper.shape_keys = seen
    return wrapper


def compiled_solver(
    cfg: MaximizerConfig, normalize: bool = False, fused_oracle: bool = False,
    engine: str = "agd",
):
    """`(instance, lam0) -> RawSolve` for one tenant."""
    key = (cfg, normalize, fused_oracle, engine)
    fn = _SINGLE.get(key)
    if fn is None:
        fn = _instrument(
            lambda inst, lam0: _raw_solve(
                inst, lam0, cfg, normalize, fused_oracle, engine=engine
            ),
            "single",
        )
        _SINGLE[key] = fn
    return fn


def compiled_solver_fixed_sigma(
    cfg: MaximizerConfig, normalize: bool = False, fused_oracle: bool = False,
    engine: str = "agd",
):
    """`(instance, lam0, sigma_sq) -> RawSolve` skipping the power iteration.

    The power iteration costs `cfg.power_iters` passes of A A^T over every
    slab per solve.  sigma_max(A) depends only on the coefficients, so a
    cadence that changed no coefficient reuses the previous estimate.
    `RawSolve.sigma_sq` echoes the passed value.
    """
    key = (cfg, normalize, fused_oracle, engine)
    fn = _SINGLE_SIGMA.get(key)
    if fn is None:
        fn = _instrument(
            lambda inst, lam0, sigma_sq: _raw_solve(
                inst, lam0, cfg, normalize, fused_oracle,
                sigma_sq=sigma_sq, engine=engine,
            ),
            "single_sigma",
        )
        _SINGLE_SIGMA[key] = fn
    return fn


def to_solve_result(raw: RawSolve) -> SolveResult:
    """`SolveResult` view of a (single-tenant) RawSolve; the step sizes,
    iteration counts and restarts are read to the host."""
    return SolveResult(
        lam=raw.lam,
        x_slabs=raw.x_slabs,
        g=raw.g,
        stats=raw.stats,
        sigma_sq=raw.sigma_sq,
        steps=tuple(float(e) for e in raw.etas),
        iters_used=tuple(int(i) for i in raw.iters),
        restarts=int(raw.restarts),
    )


def device_put_instance(inst: BucketedInstance, device="cuda") -> BucketedInstance:
    """Copy every slab leaf to `device` once (the O(nnz) bootstrap transfer).

    The result OWNS its memory, on the CPU too: the ingestor keeps editing
    its host slabs in place (through numpy views), so a "device copy" that
    aliased them would silently follow later host edits and no longer hold
    the generation it was uploaded at.
    """
    dev = resolve_device(device)
    put = lambda t: None if t is None else t.to(dev, copy=True)
    return dataclasses.replace(
        inst,
        buckets=tuple(
            dataclasses.replace(
                b, idx=put(b.idx), coeff=put(b.coeff), cost=put(b.cost),
                mask=put(b.mask), coeff_scale=put(b.coeff_scale),
                cost_scale=put(b.cost_scale),
            )
            for b in inst.buckets
        ),
        rhs=put(inst.rhs),
    )


def _expand_runs(op: BucketScatter, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Expansion of a BucketScatter's run encoding to cell coordinates on
    `device`.  Only the [R] run descriptors cross to it; the per-cell
    (rows, slots) are rebuilt there, with the cell count known on the host
    (`output_size`), so nothing waits for the device."""
    k = op.num_cells
    run_rows = op.run_rows.to(device).long()
    run_slots = op.run_slots.to(device).long()
    run_lengths = op.run_lengths.to(device).long()
    run_of = torch.repeat_interleave(
        torch.arange(op.num_runs, device=device), run_lengths, output_size=k
    )
    starts = torch.cumsum(run_lengths, 0) - run_lengths
    rows = run_rows[run_of]
    slots = run_slots[run_of] + (torch.arange(k, device=device) - starts[run_of])
    return rows, slots


def _replayed(slab: torch.Tensor, index: tuple, values: torch.Tensor) -> torch.Tensor:
    """A copy of `slab` with `values` written at `index`.  The plan's values
    carry the slab dtype already (the ingestor's host cells), so no cast
    may happen here: a mismatch raises."""
    if values.dtype != slab.dtype:
        raise ValueError(
            f"scatter plan carries {values.dtype} cells for a {slab.dtype} slab"
        )
    out = slab.clone()
    out[index] = values.to(slab.device)
    return out


def apply_scatter_plan(inst: BucketedInstance, plan: ScatterPlan) -> BucketedInstance:
    """Replay one `ScatterPlan` on device-resident slabs; the input instance
    is left untouched.

    Each touched bucket's tensors are cloned on the device and the plan's
    cells written into the clones (an indexed write at unique cells, so the
    replay is deterministic).  Only the plan's run descriptors and values
    cross the host→device boundary (`plan.nbytes`); the clones are
    device-to-device copies.  Touched cells receive the exact host-slab
    values the plan carries, so the result is bit-for-bit equal to
    re-uploading the mutated host slabs.
    """
    buckets = list(inst.buckets)
    dev = inst.device
    for op in plan.ops:
        b: Bucket = buckets[op.bucket]
        rows, slots = _expand_runs(op, dev)
        cell = (rows, slots)
        buckets[op.bucket] = dataclasses.replace(
            b,
            idx=_replayed(b.idx, cell, op.idx),
            coeff=_replayed(b.coeff, (slice(None), rows, slots), op.coeff),
            cost=_replayed(b.cost, cell, op.cost),
            mask=_replayed(b.mask, cell, op.mask),
        )
    rhs = inst.rhs if plan.rhs is None else plan.rhs.to(dev, copy=True)
    return dataclasses.replace(inst, buckets=tuple(buckets), rhs=rhs)


def instance_nbytes(inst: BucketedInstance) -> int:
    """Total slab bytes — what a full (re-)upload of the instance transfers."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(inst)))


def compile_cache_report() -> dict[str, int]:
    """Number of instance shape keys seen per entry point (shape-keyed reuse)."""
    report = {}
    for name, cache in (("single", _SINGLE), ("single_sigma", _SINGLE_SIGMA)):
        for (cfg, normalize, fused_oracle, engine), fn in cache.items():
            key = (
                f"{name}:engine={engine},gammas={cfg.gammas},"
                f"iters={cfg.iters_per_stage},"
                f"tol=({cfg.tol_grad},{cfg.tol_viol}),norm={normalize},"
                f"fused={fused_oracle}"
            )
            report[key] = len(fn.shape_keys)
    return report
