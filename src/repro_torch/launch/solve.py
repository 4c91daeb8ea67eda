"""One-shot solve CLI: the paper's workload end to end, on one card or
column-sharded over several.

    PYTHONPATH=src python -m repro_torch.launch.solve --sources 100000 \
        [--fused-oracle | --fused-kernel] [--slab-dtype float32] [--device cuda]
    PYTHONPATH=src torchrun --nproc_per_node N -m repro_torch.launch.solve \
        --shards N [--comm-mode psum] [--compress none] ...

Port of `repro.launch.solve` (the AGD engine, the matching formulation):
generate the instance, pack it, Jacobi-normalize it, and run AGD with
gamma-continuation, on one device or, with `--shards N > 1`, with one
process per card (`core.sharding.DistributedMaximizer`).  Prints what the
JAX CLI prints (rank 0 only).  `--device cuda` (the default) needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

import torch.distributed as tdist

from repro_torch.core import (
    DistConfig, DistributedMaximizer, Maximizer, MaximizerConfig,
    MatchingObjective, SolveResult, normalize_rows,
)
from repro_torch.device import resolve_device
from repro_torch.launch import dist as launch_dist
from repro_torch.instances import (
    BucketedInstance, EdgeListInstance, MatchingInstanceSpec, bucketize,
    generate_matching_instance, unpack_primal,
)

__all__ = ["SolveRun", "build_parser", "main", "run"]

_NOT_PORTED = "not ported yet"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--sources", type=int, default=100_000)
    ap.add_argument("--destinations", type=int, default=1_000)
    ap.add_argument("--families", type=int, default=1)
    ap.add_argument("--avg-degree", type=float, default=8.0)
    ap.add_argument("--iters-per-stage", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slab-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="slab storage dtype (coeff/cost/mask); duals and "
                         "all accumulation stay fp32")
    ap.add_argument("--fused-kernel", action="store_true",
                    help="fused primal step (one kernel launch per bucket "
                         "per iteration computes x)")
    ap.add_argument("--fused-oracle", action="store_true",
                    help="one-pass fused dual oracle (one kernel launch per "
                         "bucket per iteration)")
    ap.add_argument("--shards", type=int, default=1,
                    help="processes of the column-sharded solve, one per "
                         "card (run under torchrun --nproc_per_node N)")
    ap.add_argument("--comm-mode", default="psum", choices=["psum", "rank0"])
    ap.add_argument("--compress", default="none", choices=["none", "bf16", "bf16_ef"])
    ap.add_argument("--tol-grad", type=float, default=None,
                    help="relative gradient-norm tolerance (enables early stop)")
    ap.add_argument("--tol-viol", type=float, default=None,
                    help="max-violation tolerance (enables early stop)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # reference options this port does not run yet: refused below
    ap.add_argument("--engine", default="agd", choices=["agd", "pdhg", "auto"])
    ap.add_argument("--formulation", default="matching")
    return ap


@dataclasses.dataclass
class SolveRun:
    edges: EdgeListInstance
    instance: BucketedInstance  # packed and Jacobi-normalized (all rows)
    objective: MatchingObjective  # this process's (its rows when sharded)
    config: MaximizerConfig
    result: SolveResult
    setup_s: float
    solve_s: float
    total_iters: int
    budget: int
    # matched value of the unpacked primal; None on ranks other than 0
    value: Optional[float]
    violation: float  # max(0, Ax - b) at the last iteration
    shards: int
    rank: int


def _refuse(ap: argparse.ArgumentParser, args) -> None:
    """The reference's own refusals, then the options not ported yet."""
    if args.formulation != "matching" and (args.fused_kernel or args.fused_oracle):
        ap.error("--fused-kernel/--fused-oracle implement the simplex "
                 "feasible set; only --formulation matching can use them")
    if args.engine == "pdhg":
        if args.formulation != "matching":
            ap.error("--engine pdhg solves the simplex-constrained matching "
                     "LP; only --formulation matching is supported")
        if args.fused_kernel:
            ap.error("--engine pdhg fuses its prox step through the one-pass "
                     "dual oracle; use --fused-oracle, not --fused-kernel")
        ap.error(f"--engine pdhg is {_NOT_PORTED}")
    if args.formulation != "matching":
        ap.error(f"--formulation {args.formulation} is {_NOT_PORTED}")
    if args.shards < 1:
        ap.error("--shards must be at least 1")


def run(args) -> SolveRun:
    """Generate, pack, normalize and solve as the arguments say.

    With `args.shards > 1` this process must be one of a process group of
    that size (`launch.dist.setup`); every process builds the whole
    instance on the host and keeps its own rows on its device.
    """
    shards = args.shards
    if shards > 1:
        if not tdist.is_initialized() or tdist.get_world_size() != shards:
            raise RuntimeError(
                f"--shards {shards} needs a process group of {shards} processes "
                f"(torchrun --nproc_per_node {shards} ...)"
            )
        device = launch_dist.local_device(args.device)
    else:
        device = resolve_device(args.device)
    spec = MatchingInstanceSpec(
        num_sources=args.sources, num_destinations=args.destinations,
        avg_degree=args.avg_degree, num_families=args.families, seed=args.seed,
    )
    t0 = time.perf_counter()
    edges = generate_matching_instance(spec)
    packed = bucketize(edges, shard_multiple=shards, dtype=args.slab_dtype,
                       device=device if shards == 1 else "cpu")
    scaled, _ = normalize_rows(packed)
    setup_s = time.perf_counter() - t0

    cfg = MaximizerConfig(iters_per_stage=args.iters_per_stage,
                          tol_grad=args.tol_grad, tol_viol=args.tol_viol)
    if shards > 1:
        solver = DistributedMaximizer(
            scaled, cfg,
            DistConfig(comm_mode=args.comm_mode, compress=args.compress,
                       fused_kernel=args.fused_kernel,
                       fused_oracle=args.fused_oracle),
            device=device,
        )
        obj, rank = solver.objective, solver.rank
    else:
        obj = MatchingObjective(scaled, fused_kernel=args.fused_kernel,
                                fused_oracle=args.fused_oracle)
        solver, rank = Maximizer(obj, cfg), 0
    _sync(device)
    t0 = time.perf_counter()
    res = solver.solve()
    _sync(device)
    solve_s = time.perf_counter() - t0
    x_slabs = solver.gather_primal(res.x_slabs) if shards > 1 else res.x_slabs
    value = None
    if rank == 0:
        value = -float(np.dot(edges.cost, unpack_primal(packed, x_slabs)))
    return SolveRun(
        edges=edges, instance=scaled, objective=obj, config=cfg, result=res,
        setup_s=setup_s, solve_s=solve_s,
        total_iters=res.total_iters_used or cfg.total_iters,
        budget=cfg.total_iter_budget if cfg.early_stop else cfg.total_iters,
        value=value,
        violation=float(res.stats[-1].max_violation[-1]),
        shards=shards, rank=rank,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[list[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    _refuse(ap, args)
    joined = args.shards > 1 and not tdist.is_initialized()
    if joined:
        if not launch_dist.under_torchrun():
            ap.error(f"--shards {args.shards} runs one process per card: "
                     f"torchrun --nproc_per_node {args.shards} -m repro_torch.launch.solve ...")
        launch_dist.setup(args.device)
    r = run(args)
    if joined:
        launch_dist.teardown()
    if r.rank != 0:
        return 0
    print(f"generated {r.edges.nnz} nnz in {r.setup_s:.1f}s; shards={r.shards}; "
          f"formulation=matching; slab_dtype={args.slab_dtype}")
    dt = r.solve_s
    print(f"solved in {dt:.1f}s ({dt / max(r.total_iters, 1) * 1e3:.2f} ms/iter, "
          f"{r.total_iters}/{r.budget} iters, engine=agd)")
    print(f"g = {float(r.result.g):.6f}  value = {r.value:.4f}  "
          f"viol = {r.violation:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
