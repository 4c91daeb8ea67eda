"""One-shot solve CLI: the paper's workload end to end on one card.

    PYTHONPATH=src python -m repro_torch.launch.solve --sources 100000 \
        [--fused-oracle] [--slab-dtype float32] [--device cuda]

Port of `repro.launch.solve` for a single device: generate the instance,
pack it, Jacobi-normalize it, and run AGD with gamma-continuation.  Prints
what the JAX CLI prints.  `--device cuda` (the default) needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import (
    Maximizer, MaximizerConfig, MatchingObjective, SolveResult, normalize_rows,
)
from repro_torch.device import resolve_device
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
    ap.add_argument("--fused-oracle", action="store_true",
                    help="one-pass fused dual oracle (one kernel launch per "
                         "bucket per iteration)")
    ap.add_argument("--tol-grad", type=float, default=None,
                    help="relative gradient-norm tolerance (enables early stop)")
    ap.add_argument("--tol-viol", type=float, default=None,
                    help="max-violation tolerance (enables early stop)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # reference options this port does not run yet: refused below
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--engine", default="agd", choices=["agd", "pdhg", "auto"])
    ap.add_argument("--fused-kernel", action="store_true")
    ap.add_argument("--formulation", default="matching")
    return ap


@dataclasses.dataclass
class SolveRun:
    edges: EdgeListInstance
    instance: BucketedInstance  # packed and Jacobi-normalized
    objective: MatchingObjective
    config: MaximizerConfig
    result: SolveResult
    setup_s: float
    solve_s: float
    total_iters: int
    budget: int
    value: float  # matched value of the unpacked primal
    violation: float  # max(0, Ax - b) at the last iteration


def _refuse_unported(ap: argparse.ArgumentParser, args) -> None:
    if args.shards > 1:
        ap.error(f"--shards > 1 is {_NOT_PORTED}")
    if args.engine == "pdhg":
        ap.error(f"--engine pdhg is {_NOT_PORTED}")
    if args.fused_kernel:
        ap.error(f"--fused-kernel is {_NOT_PORTED}")
    if args.formulation != "matching":
        ap.error(f"--formulation {args.formulation} is {_NOT_PORTED}")


def run(args) -> SolveRun:
    """Generate, pack, normalize and solve as the arguments say."""
    device = resolve_device(args.device)
    spec = MatchingInstanceSpec(
        num_sources=args.sources, num_destinations=args.destinations,
        avg_degree=args.avg_degree, num_families=args.families, seed=args.seed,
    )
    t0 = time.perf_counter()
    edges = generate_matching_instance(spec)
    packed = bucketize(edges, dtype=args.slab_dtype, device=device)
    scaled, _ = normalize_rows(packed)
    setup_s = time.perf_counter() - t0

    cfg = MaximizerConfig(iters_per_stage=args.iters_per_stage,
                          tol_grad=args.tol_grad, tol_viol=args.tol_viol)
    obj = MatchingObjective(scaled, fused_oracle=args.fused_oracle)
    _sync(device)
    t0 = time.perf_counter()
    res = Maximizer(obj, cfg).solve()
    _sync(device)
    solve_s = time.perf_counter() - t0
    x = unpack_primal(packed, res.x_slabs)
    return SolveRun(
        edges=edges, instance=scaled, objective=obj, config=cfg, result=res,
        setup_s=setup_s, solve_s=solve_s,
        total_iters=res.total_iters_used or cfg.total_iters,
        budget=cfg.total_iter_budget if cfg.early_stop else cfg.total_iters,
        value=-float(np.dot(edges.cost, x)),
        violation=float(res.stats[-1].max_violation[-1]),
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[list[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)
    r = run(args)
    print(f"generated {r.edges.nnz} nnz in {r.setup_s:.1f}s; shards=1; "
          f"formulation=matching; slab_dtype={args.slab_dtype}")
    dt = r.solve_s
    print(f"solved in {dt:.1f}s ({dt / max(r.total_iters, 1) * 1e3:.2f} ms/iter, "
          f"{r.total_iters}/{r.budget} iters, engine=agd)")
    print(f"g = {float(r.result.g):.6f}  value = {r.value:.4f}  "
          f"viol = {r.violation:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
