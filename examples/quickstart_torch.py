"""Quickstart on the PyTorch port: build a matching LP, solve it with the
paper's pipeline, check it (port of examples/quickstart.py).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

`--device` defaults to cuda, which raises without a card.  The instance is
the reference's (numpy, seed 0), so no initial state is drawn here; the
power iteration draws its start vector from a torch generator seeded 0.
The objective is the unfused one with the plain simplex projection, as the
reference's: no kernel of the port runs.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import (
    Maximizer,
    MaximizerConfig,
    MatchingObjective,
    normalize_rows,
)
from repro_torch.device import resolve_device
from repro_torch.instances import (
    MatchingInstanceSpec,
    bucketize,
    generate_matching_instance,
    unpack_primal,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python examples/quickstart_torch.py")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


@dataclasses.dataclass
class Quickstart:
    """What the quickstart printed, at full precision."""

    nnz: int
    buckets: list  # (length, rows) per bucket
    g: float
    sigma_sq: float
    matched_value: float
    max_violation: float
    mass_per_source: float


def run(args) -> Quickstart:
    dev = resolve_device(args.device)
    # 1. a synthetic matching workload (Appendix A): 5k users x 200 items
    spec = MatchingInstanceSpec(
        num_sources=5_000, num_destinations=200, avg_degree=6.0, seed=0
    )
    inst = generate_matching_instance(spec)
    print(f"instance: {spec.num_sources} sources, {spec.num_destinations} "
          f"destinations, {inst.nnz} eligible pairs")

    # 2. pack into the bucketed-ELL layout + Jacobi row normalization
    packed = bucketize(inst, device=dev)
    scaled, _ = normalize_rows(packed)
    buckets = [(b.length, b.rows) for b in scaled.buckets]
    print("buckets:", buckets)

    # 3. solve: accelerated dual ascent with the paper's gamma continuation
    obj = MatchingObjective(scaled)
    res = Maximizer(obj, MaximizerConfig(iters_per_stage=300)).solve()
    g, sigma_sq = float(res.g), float(res.sigma_sq)
    print(f"dual objective g = {g:.4f}  (sigma_max^2 = {sigma_sq:.3f})")

    # 4. recover and check the primal
    x = unpack_primal(packed, res.x_slabs)
    matched_value = -float(np.dot(inst.cost, x))
    viol = float(res.stats[-1].max_violation[-1])
    print(f"matched value = {matched_value:.4f}, max violation = {viol:.2e}")
    mass = x.sum() / spec.num_sources
    print(f"assignment mass per source (mean) = {mass:.3f}")
    return Quickstart(inst.nnz, buckets, g, sigma_sq, matched_value, viol, float(mass))


def main(argv: Optional[list[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
