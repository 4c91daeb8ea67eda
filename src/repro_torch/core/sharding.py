"""Column-sharded solve over `torch.distributed` (port of `repro.core.sharding`).

One process per card.  Each holds a contiguous block of every bucket's rows
(the split of A's columns by source that the reference's P(axes, None)
gives) and a replicated copy of lam and b.  Per iteration each process runs
its local oracle (`include_rhs=False`), and ONE collective of the packed
[m*J + 2] payload (A x, c'x, (gamma/2)||x||^2) gives every process the
global gradient; the AGD update is then the same in every process.  The
volume per iteration depends only on m*J, never on sources or the number of
processes (paper §4.4).

  comm_mode "psum"   one all_reduce per iteration
  comm_mode "rank0"  the paper's schedule: reduce to rank 0, which then
                     broadcasts the reduced total (two collectives)
  compress "bf16"    the payload crosses the wire as bf16
  compress "bf16_ef" the same with per-process error feedback (the
                     quantization error is carried into the next iteration)

b is applied once, after the reduction.  The process group must exist
(`repro_torch.launch.dist.setup`): NCCL for CUDA, gloo for the CPU.  With
early stopping every process votes once per `check_every` chunk and a stage
ends only on a unanimous vote (one int32 all_reduce), so all processes run
the same iterations and their collectives stay matched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as tdist

from repro_torch.core.maximizer import MaximizerConfig, SolveResult, _continuation
from repro_torch.core.objective import DualEval, MatchingObjective
from repro_torch.core.projections import ProjectionMap, UnitSimplexProjection
from repro_torch.instances.buckets import BucketedInstance

__all__ = [
    "COMM_MODES",
    "COMPRESS",
    "DistConfig",
    "DistributedMaximizer",
    "all_converged",
    "all_reduce_sum",
    "gather_rows",
    "shard_instance",
]

COMM_MODES = ("psum", "rank0")
COMPRESS = ("none", "bf16", "bf16_ef")


@dataclasses.dataclass(frozen=True)
class DistConfig:
    comm_mode: str = "psum"  # "psum" | "rank0"
    compress: str = "none"  # "none" | "bf16" | "bf16_ef"
    # the fused primal kernel for each process's primal step
    fused_kernel: bool = False
    # the one-pass fused dual oracle for each process's local calculate
    # (subsumes fused_kernel)
    fused_oracle: bool = False

    def __post_init__(self):
        for name, value, choices in (("comm_mode", self.comm_mode, COMM_MODES),
                                     ("compress", self.compress, COMPRESS)):
            if value not in choices:
                raise ValueError(f"DistConfig.{name}={value!r}; choose from {choices}")


def shard_instance(inst: BucketedInstance, rank: int, world: int) -> BucketedInstance:
    """Process `rank`'s block of rows of every bucket; rhs replicated.

    Every bucket's row count must be a multiple of `world`
    (`bucketize(shard_multiple=world)`), so each process sees the same
    shapes.  The block is a view where it is contiguous already (always for
    `world == 1`).  The local instance cannot `unpack_primal`; gather its
    slabs first (`gather_rows`).
    """
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    buckets = []
    for b in inst.buckets:
        if b.rows % world:
            raise ValueError(
                f"bucket of width {b.length} has {b.rows} rows, not a multiple of "
                f"{world} processes: bucketize with shard_multiple={world}"
            )
        lo, hi = rank * b.rows // world, (rank + 1) * b.rows // world
        buckets.append(dataclasses.replace(
            b, idx=b.idx[lo:hi].contiguous(), coeff=b.coeff[:, lo:hi].contiguous(),
            cost=b.cost[lo:hi].contiguous(), mask=b.mask[lo:hi].contiguous(),
        ))
    return dataclasses.replace(inst, buckets=tuple(buckets), pack_info=None)


def all_reduce_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum of `v` over the processes (a new tensor; `v` is untouched)."""
    out = v.reshape(-1).clone()
    tdist.all_reduce(out)
    return out.reshape(v.shape)


def all_converged(done: torch.Tensor) -> torch.Tensor:
    """Collective stop predicate: every process must vote converged (one
    int32 all_reduce)."""
    votes = done.to(torch.int32).reshape(1)
    tdist.all_reduce(votes)
    return votes[0] == tdist.get_world_size()


def gather_rows(x_slabs) -> Optional[tuple[torch.Tensor, ...]]:
    """The whole primal slabs on rank 0 (None elsewhere): every process's
    rows in rank order, for `unpack_primal` with the whole instance.  One
    broadcast per bucket and process."""
    rank, world = tdist.get_rank(), tdist.get_world_size()
    full = []
    for x in x_slabs:
        x, parts = x.contiguous(), []
        for src in range(world):
            buf = x if src == rank else torch.empty_like(x)
            tdist.broadcast(buf, src=src)
            parts.append(buf)
        full.append(torch.cat(parts))
    return tuple(full) if rank == 0 else None


def _make_calculate(local_obj: MatchingObjective, dist: DistConfig, rhs: torch.Tensor):
    """The sharded `calculate(lam, gamma, comm) -> (DualEval, comm)`: local
    work, then one reduction of the packed payload (two in "rank0" mode)."""

    def calculate(lam, gamma, comm):
        ev = local_obj.calculate(lam, gamma)  # include_rhs=False: local parts
        contrib = torch.cat([ev.ax, torch.stack([ev.primal_linear, ev.primal_ridge])])
        if dist.compress != "none":
            if dist.compress == "bf16_ef":
                contrib = contrib + comm  # add the carried quantization error
            sent = contrib.to(torch.bfloat16)  # the wire payload IS bf16
            if dist.compress == "bf16_ef":
                comm = contrib - sent.float()
            contrib = sent
        if dist.comm_mode == "rank0":
            tdist.reduce(contrib, dst=0)  # 'reduce' hop
            tdist.broadcast(contrib, src=0)  # rank 0 broadcasts the total
        else:
            tdist.all_reduce(contrib)
        total = contrib.float()
        ax, lin, ridge = total[:-2], total[-2], total[-1]
        grad = ax - rhs
        g = lin + ridge + torch.dot(lam, grad)
        return (
            DualEval(g=g, grad=grad, x_slabs=ev.x_slabs,
                     primal_linear=lin, primal_ridge=ridge, ax=ax),
            comm,
        )

    return calculate


class DistributedMaximizer:
    """Maximizer over a column-sharded instance (paper §4.4).

    Takes the whole instance in every process and keeps this process's rows
    (`shard_instance`, moved to `device` when given).  The continuation
    schedule and the AGD stage loops are the single-device ones
    (`core.maximizer`); this class adds the sharded `calculate`, the sharded
    power iteration (one all_reduce of A A^T u per step), the unanimous stop
    vote; `gather_rows` reassembles the primal on rank 0.
    """

    def __init__(
        self,
        inst: BucketedInstance,
        config: MaximizerConfig = MaximizerConfig(),
        dist: DistConfig = DistConfig(),
        projection: Optional[ProjectionMap] = None,
        *,
        device=None,
    ):
        if not tdist.is_initialized():
            raise RuntimeError(
                "DistributedMaximizer needs a process group: call "
                "repro_torch.launch.dist.setup (or run under torchrun) first"
            )
        self.rank, self.world = tdist.get_rank(), tdist.get_world_size()
        self.config = config
        self.dist = dist
        self.projection = projection or UnitSimplexProjection()
        local = shard_instance(inst, self.rank, self.world)
        self.local = local if device is None else local.to(device)
        self.objective = MatchingObjective(
            self.local, projection=self.projection, include_rhs=False,
            fused_kernel=dist.fused_kernel, fused_oracle=dist.fused_oracle,
        )

    def _comm0(self) -> Optional[torch.Tensor]:
        """A fresh error-feedback accumulator (every stage starts at zero)."""
        if self.dist.compress != "bf16_ef":
            return None
        return torch.zeros(self.objective.dual_dim + 2, dtype=torch.float32,
                           device=self.local.device)

    def power_iteration(self) -> torch.Tensor:
        """sigma_max(A)^2 estimate: the objective's power iteration with
        A A^T u all-reduced at every step, from the same start vector as
        the single-device solve."""
        return self.objective.power_iteration(
            self.config.seed, iters=self.config.power_iters, reduce=all_reduce_sum
        )

    def solve(self, lam0: Optional[torch.Tensor] = None) -> SolveResult:
        """The continuation solve; lam, g and the traces are the same in
        every process, x_slabs are this process's rows."""
        lam = (
            torch.zeros(self.objective.dual_dim, dtype=torch.float32,
                        device=self.local.device)
            if lam0 is None else lam0
        )
        return _continuation(
            _make_calculate(self.objective, self.dist, self.local.rhs), lam,
            self.power_iteration(), self.config, comm0=self._comm0,
            stop_reduce=all_converged,
        )
