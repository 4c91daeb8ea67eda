"""Allocation-serving demo: query the dual store while the fleet re-solves
(port of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        [--sources 4000] [--tenants 2] [--cadences 3] [--batch 128] \
        [--hammer-threads 2] [--verify] \
        [--metrics-out m.jsonl] [--prom-out m.prom] [--device cuda]

A `Scheduler` with an attached `DualStore` publishes every tenant's duals as
a generation-stamped snapshot after each cadence solve, while hammer threads
batch-query allocations the whole time — including mid-solve, across the
pipeline's snapshot swaps.  Each answered batch reports the generation it
was served from; the demo prints per-tenant p50/p99 batch latency,
users/second and the generations observed.  On the card every hammer thread
queries on its own CUDA stream, which waits on the snapshot's publish event
before it reads the duals; a simplex tenant's query is one launch of kernel
2 over the requested rows.

`--verify` replays every answered batch post-hoc against the retained
snapshot of the generation it reported and checks the served allocations
BIT-identical to the direct full-slab projection.  `--metrics-out` appends
one ``serving_query`` JSONL record per batch plus a final ``counters``
snapshot; `--prom-out` writes a Prometheus text-exposition snapshot.
`--device cuda` (the default) needs a card; `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from typing import Optional

__all__ = ["ServeRun", "build_parser", "main", "run"]


def _delta(edge_list, rng, frac=0.02):
    import numpy as np

    from repro_torch.instances import InstanceDelta

    n = max(1, int(frac * edge_list.nnz))
    pick = rng.choice(edge_list.nnz, size=n, replace=False)
    return InstanceDelta(
        update_src=edge_list.src[pick],
        update_dst=edge_list.dst[pick],
        update_values=edge_list.values[pick] * rng.uniform(0.9, 1.1, n),
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--sources", type=int, default=4000)
    ap.add_argument("--destinations", type=int, default=50)
    ap.add_argument("--avg-degree", type=float, default=6.0)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--cadences", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hammer-threads", type=int, default=2)
    ap.add_argument("--iters-per-stage", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="replay every batch against the snapshot of the "
                         "generation it reported; check bit-identical")
    ap.add_argument("--metrics-out", default=None,
                    help="append serving_query JSONL records here")
    ap.add_argument("--prom-out", default=None,
                    help="write a Prometheus text-exposition snapshot")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


@dataclasses.dataclass
class ServeRun:
    """What one run did, for callers that drive the CLI in process."""

    scheduler: object
    store: object
    outs: list  # the pipeline's CadenceReports
    results: list  # every served QueryResult
    wall_seconds: float
    failures: Optional[int]  # mismatched batches under --verify
    code: int


def run(args) -> ServeRun:
    """The CLI's run, printing what the reference prints."""
    import numpy as np
    import torch

    from repro_torch import telemetry
    from repro_torch.core import MaximizerConfig
    from repro_torch.device import resolve_device
    from repro_torch.instances import MatchingInstanceSpec, generate_matching_instance
    from repro_torch.service import Scheduler, ServiceConfig
    from repro_torch.serving import DualStore, direct_allocations

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    cfg = ServiceConfig(
        cold=MaximizerConfig(
            iters_per_stage=args.iters_per_stage,
            tol_grad=1e-4, tol_viol=1e-4,
        ),
        row_headroom=4,
    )
    store = DualStore(history=args.cadences + 2)
    sched = Scheduler(cfg, dual_store=store, device=device)
    bases = {}
    for i in range(args.tenants):
        name = f"t{i}"
        bases[name] = generate_matching_instance(MatchingInstanceSpec(
            num_sources=args.sources,
            num_destinations=args.destinations,
            avg_degree=args.avg_degree,
            seed=args.seed + i,
        ))
        sched.add_tenant(name, bases[name])
    print(f"{args.tenants} tenant(s), {bases['t0'].nnz} nnz each; "
          f"initial cold cadence ...")
    sched.run_cadence()
    for name in store.tenants():
        snap = store.snapshot(name)
        print(f"  {name}: published generation {snap.generation} "
              f"({snap.num_users} users, gamma={snap.gamma})")

    sink = telemetry.JsonlSink(args.metrics_out) if args.metrics_out else None
    live = {
        name: np.flatnonzero(store.snapshot(name).deg > 0)
        for name in store.tenants()
    }
    results: list = []
    errors: list = []
    lock = threading.Lock()
    stop = threading.Event()

    def hammer(worker_seed):
        qrng = np.random.default_rng(worker_seed)
        names = sorted(live)
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        try:
            while not stop.is_set():
                name = names[int(qrng.integers(len(names)))]
                users = live[name]
                batch = users[qrng.integers(0, users.size, size=args.batch)]
                if stream is None:
                    r = store.query(name, batch)
                else:
                    with torch.cuda.device(device), torch.cuda.stream(stream):
                        r = store.query(name, batch)
                with lock:
                    results.append(r)
                    if sink is not None:
                        sink.emit("serving_query", {
                            "tenant": r.tenant,
                            "generation": r.generation,
                            "users": int(r.num_users),
                            "latency_seconds": r.latency_seconds,
                        })
        except Exception as e:  # re-raised by the main thread
            errors.append(e)

    threads = [
        threading.Thread(target=hammer, args=(args.seed + 100 + i,),
                         daemon=True)
        for i in range(args.hammer_threads)
    ]
    deltas = [
        {name: _delta(bases[name], rng) for name in bases}
        for _ in range(args.cadences)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        outs = sched.run_pipeline(deltas)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for t, out in enumerate(outs):
        gens = {n: out.reports[n]["published_generation"] for n in out.reports}
        print(f"cadence {t}: published generations {gens}")
        if out.ingest_errors:
            print(f"  ingest errors: {out.ingest_errors}")

    by_tenant: dict = {}
    for r in results:
        by_tenant.setdefault(r.tenant, []).append(r)
    total_users = sum(r.num_users for r in results)
    print(f"\nserved {len(results)} batches / {total_users} users in "
          f"{wall:.2f}s while {args.cadences} pipelined cadences solved "
          f"({total_users / max(wall, 1e-9):.0f} users/s)")
    for name in sorted(by_tenant):
        rs = by_tenant[name]
        lats = np.asarray([r.latency_seconds for r in rs]) * 1e3
        gens = sorted({r.generation for r in rs})
        print(f"  {name}: {len(rs)} batches, p50={np.percentile(lats, 50):.2f}ms "
              f"p99={np.percentile(lats, 99):.2f}ms, generations observed "
              f"{gens}")

    failures = None
    if args.verify:
        failures = 0
        directs: dict = {}
        for r in results:
            key = (r.tenant, r.generation)
            if key not in directs:
                directs[key] = [x.cpu().numpy() for x in direct_allocations(
                    store.get(r.tenant, r.generation))]
            xs = directs[key]
            for ba in r.slabs:
                if not np.array_equal(ba.x, xs[ba.bucket][ba.rows]):
                    failures += 1
        print(f"verify: {len(results)} batches replayed against their "
              f"reported generations — "
              + ("all bit-identical" if failures == 0
                 else f"{failures} MISMATCHED batches"))

    if sink is not None:
        sink.emit_counters()
        sink.close()
        print(f"metrics written to {args.metrics_out}")
    if args.prom_out:
        telemetry.write_prometheus(args.prom_out)
        print(f"prometheus snapshot written to {args.prom_out}")
    return ServeRun(sched, store, outs, results, wall, failures, 1 if failures else 0)


def main(argv: Optional[list[str]] = None) -> int:
    return run(build_parser().parse_args(argv)).code


if __name__ == "__main__":
    raise SystemExit(main())
