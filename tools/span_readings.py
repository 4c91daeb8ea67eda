#!/usr/bin/env python
"""The port's spans over a benchmark cell's run, read where the benchmark's
own result line cannot read them, and the cost of tracing.

    python3 tools/span_readings.py --runs s1m-cadence:1:off,s3.5m-solve:0:record \
        --seed 2147483651 --seconds 51

from the root of a checkout with a card, or

    python3 tools/span_readings.py --span-cost 3

for the cost of one `span()` call on the host (no card needed).  Each run is
`<workload>:<trace 0|1>:<tracer>`: `portbench.run.execute` of the cell with
the process default tracer off (`off`: the program's default), a recording
`Tracer()` (`record`) or a `Tracer(profiler_annotations=True)` (`annotate`)
installed before the run.  Every tracer the cell's traffic module
(`portbench/drivers/`) installs is kept (role `cell`), and a traced run's
profiled stretch runs under its own annotating tracer where that module
installs none (role `stretch`), so the spans of the window and of the
stretch are read apart.  One JSON line per run: the window's seconds per
unit (`unit_s`, what `cadence_s` / `solve_s` read, also for a traced run),
the result line's metrics and idle gaps, and per tracer the host and
device milliseconds of each span name per unit.  All runs share one
process, so the card's set-up is paid once.  `--span-cost R` prints one
JSON line per round of R interleaved rounds: microseconds a `with
span(...)` under the default `NullTracer` (`off`) and a recording
`Tracer` (`on`), each also with `device=` the CPU, which reads no device
clock (`off_device`, `on_device`).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def per_name(events: list, units: int) -> dict:
    """Span name -> {count, host_ms, device_ms} per unit."""
    out = {}
    for e in events:
        row = out.setdefault(e["name"], {"count": 0, "host_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += e["dur"] / 1e3
        if "device_ms" in e["args"]:
            row["device_ms"] = row.get("device_ms", 0.0) + e["args"]["device_ms"]
    for row in out.values():
        for k in ("count", "host_ms", "device_ms"):
            if k in row:
                row[k] /= max(units, 1)
    return out


def one(resolved: dict, seed: int, seconds: float, trace: bool, tracer: str,
        device: str = "cuda") -> dict:
    import torch

    from portbench import run
    from portbench import trace as ptrace
    from repro_torch import telemetry
    from repro_torch.telemetry.tracing import NullTracer

    kept, window = [], {}
    set_tracer, profile, closed_loop = telemetry.set_tracer, ptrace.profile, run.Context.closed_loop

    def keeping(t):
        kept.append(("cell", t))
        return set_tracer(t)

    def stretch(step, units, sync):
        cur = telemetry.get_tracer()
        if cur.profiler_annotations and any(t is cur for role, t in kept if role == "cell"):
            return profile(step, units, sync)  # the cell installed one for it
        t = telemetry.Tracer(profiler_annotations=True)
        kept.append(("stretch", t))
        prev = set_tracer(t)
        try:
            return profile(step, units, sync)
        finally:
            set_tracer(prev)

    def timed(ctx, step):
        telemetry.get_tracer().reset()  # the window's spans alone
        outs, elapsed = closed_loop(ctx, step)
        window.update(units=len(outs), unit_s=elapsed / len(outs))
        return outs, elapsed

    start = {"off": NullTracer,
             "record": telemetry.Tracer,
             "annotate": lambda: telemetry.Tracer(profiler_annotations=True)}[tracer]()
    kept.append(("installed", start))
    set_tracer(start)
    telemetry.set_tracer, ptrace.profile, run.Context.closed_loop = keeping, stretch, timed
    try:
        result = run.execute(resolved, seed, seconds, trace, device=device,
                             t_start=time.perf_counter())
    finally:
        telemetry.set_tracer, ptrace.profile, run.Context.closed_loop = \
            set_tracer, profile, closed_loop
        set_tracer(NullTracer())
    reg = telemetry.get_registry()
    edits, deltas = reg.counter_total("delta_edits_total"), reg.counter_total("deltas_applied_total")
    tracers = []
    for role, t in kept:
        events = t.events()
        units = sum(e["name"] == "cadence" for e in events) or \
            (window["units"] if role != "stretch" else resolved["traffic"]["profiled_units"])
        tracers.append({"role": role, "annotations": t.profiler_annotations,
                        "events": len(events), "units": units,
                        "spans": per_name(events, units)})
    line = {"workload": resolved["cell"]["name"], "seed": seed, "trace": trace,
            "tracer": tracer, "correct": result["correct"], **window,
            "metrics": result["metrics"], "edits_per_delta": edits / deltas if deltas else None,
            "tracers": tracers}
    if trace:
        line.update(device=result["device"], breakdown=result["breakdown"])
    del result
    gc.collect()
    torch.cuda.empty_cache()
    return line


def span_cost(rounds: int, n: int = 200_000) -> list[dict]:
    """Microseconds a `with span(...)` costs, per round, each case timed over
    `n` spans (a recording tracer is reset before each case)."""
    import torch

    from repro_torch import telemetry
    from repro_torch.telemetry.tracing import NullTracer

    cpu = torch.device("cpu")
    cases = {"off": (NullTracer, {}), "on": (telemetry.Tracer, {}),
             "off_device": (NullTracer, {"device": cpu}),
             "on_device": (telemetry.Tracer, {"device": cpu})}
    out = []
    prev = telemetry.get_tracer()
    try:
        for _ in range(rounds):
            row = {}
            for case, (make, kw) in cases.items():
                telemetry.set_tracer(make(max_events=n) if make is telemetry.Tracer else make())
                t0 = time.perf_counter()
                for _ in range(n):
                    with telemetry.span("s", x=1, **kw):
                        pass
                row[case] = (time.perf_counter() - t0) / n * 1e6
            out.append(row)
    finally:
        telemetry.set_tracer(prev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/span_readings.py")
    ap.add_argument("--runs",
                    help="comma-separated <workload>:<trace 0|1>:<off|record|annotate>")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--span-cost", type=int, default=0, metavar="ROUNDS",
                    help="time span() off and on over ROUNDS rounds, then the runs")
    args = ap.parse_args(argv)
    if args.runs and args.seed is None:
        ap.error("--runs needs --seed")

    for row in span_cost(args.span_cost):
        print(json.dumps({"span_cost_us": row}), flush=True)
    if not args.runs:
        return 0

    from portbench import run

    for spec in args.runs.split(","):
        workload, trace, tracer = spec.split(":")
        resolved = run.load_cell(ROOT, workload)
        print(json.dumps(one(resolved, args.seed, args.seconds, trace == "1", tracer)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
