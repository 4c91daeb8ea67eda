"""End-to-end production cadence on the PyTorch port: recurring solves with
stability control (port of examples/production_solve.py).

Simulates the paper's production cadence: day-0 solve, then a day-1 solve on
perturbed data, warm-started from day-0 duals, with the gamma floor bounding
run-to-run primal drift (paper contribution 2).  Reports solve quality, drift,
and the theoretical bound.

    PYTHONPATH=src python examples/production_solve_torch.py [--sources 100000] [--device cpu]

The reference's flags and defaults, plus `--device` (default cuda, which
raises without a card).  The instances are the reference's (numpy, seeds 0
and 1), so no initial state is drawn here.  As in the reference, the cost
change `dc` that enters the bound is measured over bucket 0 alone, and the
run fails if the drift exceeds 1.01 times that bound.  Each day's time ends
on the host's copy of its g.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core import (
    MaximizerConfig,
    RecurringSolver,
    drift_bound,
    normalize_rows,
)
from repro_torch.device import resolve_device
from repro_torch.instances import (
    MatchingInstanceSpec,
    bucketize,
    generate_matching_instance,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python examples/production_solve_torch.py")
    ap.add_argument("--sources", type=int, default=50_000)
    ap.add_argument("--destinations", type=int, default=1_000)
    ap.add_argument("--gamma-floor", type=float, default=0.01)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


@dataclasses.dataclass
class ProductionSolve:
    """What the two days printed, at full precision."""

    g0: float
    viol0: float
    g1: float
    drift_l2: float
    drift_rel: float
    bound: float
    seconds: tuple  # (day 0, day 1) solve seconds


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run(args) -> ProductionSolve:
    dev = resolve_device(args.device)
    gammas = tuple(
        g for g in (1e3, 1e2, 10.0, 1.0, 0.1, 0.01) if g >= args.gamma_floor
    )
    solver = RecurringSolver(
        MaximizerConfig(gammas=gammas, iters_per_stage=120)
    )

    spec0 = MatchingInstanceSpec(
        num_sources=args.sources, num_destinations=args.destinations,
        avg_degree=8.0, seed=0,
    )
    day0 = generate_matching_instance(spec0)
    packed0, _ = normalize_rows(bucketize(day0, device=dev))

    t0 = time.time()
    res0, _ = solver.solve(packed0)
    g0 = float(res0.g)
    s0 = time.time() - t0
    viol0 = float(res0.stats[-1].max_violation[-1])
    print(f"[day 0] solved in {s0:.1f}s  g={g0:.4f}  viol={viol0:.2e}")

    # day 1: same graph, values perturbed ~2% (slowly evolving inputs)
    day1 = dataclasses.replace(day0)
    rng = np.random.default_rng(1)
    noise = 1.0 + 0.02 * rng.standard_normal(day1.nnz)
    day1.values = day1.values * noise
    day1.coeff = day1.coeff * noise
    packed1, _ = normalize_rows(bucketize(day1, device=dev))

    t0 = time.time()
    res1, report = solver.solve(packed1)
    g1 = float(res1.g)
    s1 = time.time() - t0
    dc = float(np.linalg.norm(_host(packed1.buckets[0].cost) - _host(packed0.buckets[0].cost)))
    bound = drift_bound(args.gamma_floor, dc_norm=dc, dlam_norm=float(
        np.linalg.norm(_host(res1.lam) - _host(res0.lam))))
    print(f"[day 1] warm-started solve in {s1:.1f}s  g={g1:.4f}")
    print(f"        primal drift ||x1-x0|| = {report['drift_l2']:.4f} "
          f"(relative {report['drift_rel']:.4f})")
    print(f"        theoretical bound (gamma={args.gamma_floor}): {bound:.4f}")
    assert report["drift_l2"] <= bound * 1.01, "drift bound violated!"
    print("        drift within the gamma-control bound — stability holds")
    return ProductionSolve(g0, viol0, g1, report["drift_l2"], report["drift_rel"],
                           bound, (s0, s1))


def main(argv: Optional[list[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
