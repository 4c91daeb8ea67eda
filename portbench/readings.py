"""Readings that the limits of a cell's comparison are set from: every number
the cell's driver reads, for runs of the program on many seeds and for runs
of the control (the program one precision below the configuration's), all
in one process so that the set-up of the card is paid once.

    python3 -m portbench.readings --workload s3.5m-solve --seconds 3 \
        --seeds 11,12,13 --control-seeds 21,22,23

Prints one JSON line per run.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from pathlib import Path

import torch

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    resolved = run.load_cell(Path.cwd(), args.workload)
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        t0 = time.perf_counter()
        r = run.execute(resolved, seed, args.seconds, False, t_start=t0, control=control)
        numbers = {k: c["value"] for k, c in r["checks"].items()}
        numbers.update(r["readings"])
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "numbers": numbers, "run_s": time.perf_counter() - t0,
                          "metrics": r["metrics"]}), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
