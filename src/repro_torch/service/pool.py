"""Batched multi-tenant solve pool: many small LPs in one batched solve
(port of `repro.service.pool`).

Tenants whose packed instances share identical bucket shapes are stacked
tensor by tensor along a new leading lane dimension and solved by ONE
batched continuation solve (`service.engine.compiled_batch_solver`): every
AGD iteration then evaluates the oracle of all tenants together (with the
fused oracle, one kernel call for the whole batch), amortising launch and
host overhead across the batch.

Invariants:

  * **Shape identity is the batching currency** — `stack_instances` refuses
    mixed signatures; `ServiceConfig.row_headroom` is what buys tenants a
    stable signature across deltas.
  * **Stacking is a device op** — the per-tenant slabs are already resident
    (`service.engine.device_put_instance`), so `torch.stack` copies on the
    device: batching adds no host-to-device traffic on top of the O(delta)
    scatter plans.
  * **Dispatch/fence split** — `solve_async` runs the batched solve and
    returns a `RawSolve` of device tensors (the solve waits for the device
    only at its early-stopping checks); `finish` converts host-side.  The
    scheduler's pipeline runs `solve_async` on a solver thread so that host
    ingestion of the next cadence overlaps it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import telemetry
from repro_torch.core.batched import stack_lanes
from repro_torch.core.maximizer import MaximizerConfig, SolveResult
from repro_torch.instances.buckets import BucketedInstance
from repro_torch.service.engine import (
    RawSolve,
    compiled_batch_solver,
    compiled_batch_solver_fixed_sigma,
    to_solve_results,
)

__all__ = [
    "shape_signature",
    "stack_instances",
    "BatchedSolvePool",
]


def shape_signature(inst: BucketedInstance) -> tuple:
    """Hashable key of an instance's structure: its static fields (sizes,
    bucket widths, formulation) and every tensor's shape and dtype.

    Two instances with equal signatures can be stacked and solved by the
    same batched solve.  (The reference builds it from the pytree's treedef,
    which holds the same static fields.)
    """
    spec = inst.formulation
    static = (inst.num_sources, inst.num_destinations, inst.num_families,
              tuple(int(b.length) for b in inst.buckets),
              None if spec is None else repr(spec))
    leaves = []
    for b in inst.buckets:
        leaves += [t for t in (b.idx, b.coeff, b.cost, b.mask, b.coeff_scale, b.cost_scale)
                   if t is not None]
    leaves.append(inst.rhs)
    return (static, tuple((tuple(t.shape), str(t.dtype).removeprefix("torch."))
                          for t in leaves))


def stack_instances(insts: Sequence[BucketedInstance]) -> BucketedInstance:
    """Stack shape-identical instances tensor by tensor along a new lane
    dimension."""
    if not insts:
        raise ValueError("stack_instances: empty batch")
    sig0 = shape_signature(insts[0])
    for i, inst in enumerate(insts[1:], start=1):
        if shape_signature(inst) != sig0:
            raise ValueError(
                f"instance {i} has a different shape signature; "
                "group tenants with shape_signature() before stacking"
            )
    return stack_lanes(insts)


@dataclasses.dataclass
class BatchedSolvePool:
    """Solves a batch of shape-identical tenant instances in one batched call."""

    config: MaximizerConfig = dataclasses.field(default_factory=MaximizerConfig)
    # device-side Jacobi row normalization inside the solve (see engine)
    normalize: bool = False
    # one-pass fused dual oracle inside the batched solve: one oracle call
    # (one kernel launch and one finalize on the card) per iteration for
    # every tenant of the batch
    fused_oracle: bool = False
    # solver engine the whole batch runs on ("agd" | "pdhg"); the scheduler
    # keys its shape groups on the routed engine
    engine: str = "agd"

    def solve_async(
        self,
        instances: Sequence[BucketedInstance],
        lam0s: Optional[Sequence[Optional[torch.Tensor]]] = None,
        sigma_sqs: Optional[Sequence[float]] = None,
    ) -> RawSolve:
        """One batched solve; `lam0s[i] = None` cold-starts that tenant.

        ``sigma_sqs`` — one carried sigma_max(A)^2 estimate per tenant —
        routes the batch through the fixed-sigma batched solver: every lane
        skips its power iteration.  All tenants must supply one; the
        scheduler partitions groups by reuse-readiness instead.

        Returns a `RawSolve` of device tensors; pair with `finish`.
        """
        stacked = stack_instances(instances)
        dual_dim = instances[0].dual_dim
        batch = len(instances)
        dev = instances[0].device
        if lam0s is None:
            lam0s = [None] * batch
        if len(lam0s) != batch:
            raise ValueError("lam0s must match the instance batch")
        rows = [
            torch.zeros(dual_dim, dtype=torch.float32, device=dev) if l is None
            else torch.as_tensor(l, device=dev)
            for l in lam0s
        ]
        for i, r in enumerate(rows):
            if tuple(r.shape) != (dual_dim,):
                raise ValueError(
                    f"lam0s[{i}] has shape {tuple(r.shape)}, expected ({dual_dim},)"
                )
        reg = telemetry.get_registry()
        reg.inc("pool_batched_solves_total", 1)
        reg.inc("pool_tenant_solves_total", batch)
        reg.observe("pool_batch_size", batch)
        # padded slab cells per tenant of this batch's shape group — the
        # denominator of padding-waste ratios (the scheduler supplies nnz)
        cells = sum(int(b.idx.numel()) for b in instances[0].buckets)
        reg.set_gauge("pool_padded_cells", cells * batch)
        if sigma_sqs is not None:
            if len(sigma_sqs) != batch:
                raise ValueError("sigma_sqs must match the instance batch")
            if any(s is None for s in sigma_sqs):
                raise ValueError(
                    "sigma_sqs must be provided for every tenant in the "
                    "batch; split reuse-ready tenants into their own group"
                )
            reg.inc("pool_sigma_reuse_solves_total", batch)
            return compiled_batch_solver_fixed_sigma(
                self.config, self.normalize, self.fused_oracle, self.engine
            )(
                stacked,
                torch.stack(rows),
                torch.tensor([float(s) for s in sigma_sqs], dtype=torch.float32, device=dev),
            )
        return compiled_batch_solver(
            self.config, self.normalize, self.fused_oracle, self.engine
        )(stacked, torch.stack(rows))

    @staticmethod
    def finish(raw: RawSolve) -> list[SolveResult]:
        """Split a `solve_async` result into per-tenant results (reading the
        per-lane counts to the host waits for the device)."""
        return to_solve_results(raw)

    def solve(
        self,
        instances: Sequence[BucketedInstance],
        lam0s: Optional[Sequence[Optional[torch.Tensor]]] = None,
        sigma_sqs: Optional[Sequence[float]] = None,
    ) -> list[SolveResult]:
        """One blocking batched solve (`solve_async` + `finish`)."""
        return self.finish(self.solve_async(instances, lam0s, sigma_sqs))
