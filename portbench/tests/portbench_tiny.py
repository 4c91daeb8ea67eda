"""Shared pieces of the benchmark's tests: tiny cells, resolved from the
checkout's own files and cut to a size the CPU solves in seconds."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = {"num_sources": 800, "num_destinations": 32}
TINY_TRAFFIC = {"iters_per_stage": 15, "pool_cadence_s": 0.005, "profiled_units": 1}


def tiny(workload: str) -> dict:
    """The cell `workload` as the benchmark resolves it, cut to a tiny size."""
    from portbench import run

    r = run.load_cell(ROOT, workload)
    r["config"] = dict(r["config"], **TINY_CONFIG)
    r["traffic"] = dict(r["traffic"], **TINY_TRAFFIC)
    return r
