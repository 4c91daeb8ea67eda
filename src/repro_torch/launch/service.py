"""Recurring-solve service demo: multi-tenant cadences end to end (port of
`repro.launch.service`).

    PYTHONPATH=src python -m repro_torch.launch.service \
        [--sources 2000] [--tenants 4] [--cadences 3] [--verify] \
        [--checkpoint-dir ckpts/service] [--resume] [--dry-run] \
        [--metrics-out m.jsonl] [--trace-out t.json] [--prom-out m.prom] \
        [--device cuda]

Simulates a production serving loop: N tenants share one eligibility topology
(so their packed shapes match and the scheduler solves them in ONE batched
solve), each cadence applies per-tenant deltas (cost updates, a few edge
inserts/deletes inside the padding headroom, budget jitter), and every solve
after the first warm-starts from the tenant's previous duals on a shortened
continuation schedule with convergence-based early stopping.  Slabs stay
device-resident across cadences: each solve reports its host→device upload —
one full O(nnz) transfer at bootstrap, then O(delta) scatter plans.

`--checkpoint-dir` persists every tenant session after each cadence through
`repro_torch.checkpoint.CheckpointManager` (the reference's format);
`--resume` restarts from the latest checkpoint so every tenant's first solve
after the restart is WARM.  `--dry-run` ingests one delta per tenant and
prints the scatter-plan sizes without solving.  `--verify` cross-checks, for
one tenant, the warm delta-updated solve against a cold full-budget solve of
the same instance (same objective, fewer iterations) and the batched pool
against sequential per-tenant solves.  `--fused-oracle` runs every solve
through the one-pass oracle (on the card one kernel call per AGD iteration
for a whole batched group).  Telemetry: `--metrics-out` (JSONL),
`--trace-out` (Chrome trace), `--prom-out` (Prometheus text).  `--device
cuda` (the default) needs a card; `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

__all__ = ["ServiceRun", "build_parser", "main", "run"]


def _random_delta(edge_list, rng, *, frac_update=0.02, n_insert=3, n_delete=3,
                  rhs_jitter=0.02):
    import numpy as np

    from repro_torch.instances import InstanceDelta

    spec = edge_list.spec
    m, J, I = spec.num_families, spec.num_destinations, spec.num_sources
    nnz = edge_list.nnz
    n_upd = max(1, int(frac_update * nnz))
    perm = rng.permutation(nnz)
    upd, dele = perm[:n_upd], perm[n_upd : n_upd + n_delete]
    # the reference keeps a set of every edge key; a sorted array answers
    # the same membership test for the same draws without building the set
    keys = np.sort(edge_list.src * J + edge_list.dst)
    taken, ins_s, ins_d = set(), [], []
    while len(ins_s) < n_insert:
        s, d = int(rng.integers(I)), int(rng.integers(J))
        key = s * J + d
        pos = int(np.searchsorted(keys, key))
        if not (pos < keys.size and keys[pos] == key) and key not in taken:
            taken.add(key)
            ins_s.append(s)
            ins_d.append(d)
    return InstanceDelta(
        insert_src=ins_s,
        insert_dst=ins_d,
        insert_values=rng.uniform(0.1, 3.0, n_insert),
        insert_coeff=rng.uniform(0.1, 2.0, (m, n_insert)),
        delete_src=edge_list.src[dele],
        delete_dst=edge_list.dst[dele],
        update_src=edge_list.src[upd],
        update_dst=edge_list.dst[upd],
        update_values=edge_list.values[upd]
        * rng.uniform(0.9, 1.1, n_upd),
        rhs=np.asarray(edge_list.rhs)
        * rng.uniform(1 - rhs_jitter, 1 + rhs_jitter, m * J),
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.service",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--sources", type=int, default=2000)
    ap.add_argument("--destinations", type=int, default=40)
    ap.add_argument("--families", type=int, default=1)
    ap.add_argument("--avg-degree", type=float, default=6.0)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--cadences", type=int, default=3)
    ap.add_argument("--iters-per-stage", type=int, default=150)
    ap.add_argument("--tol-grad", type=float, default=1e-4)
    ap.add_argument("--tol-viol", type=float, default=1e-4)
    ap.add_argument("--drift-sla", type=float, default=0.25)
    ap.add_argument("--row-headroom", type=int, default=8)
    ap.add_argument("--fused-oracle", action="store_true",
                    help="one-pass fused dual oracle inside every solve")
    ap.add_argument("--sigma-reuse-threshold", type=float, default=None,
                    help="warm cadences with ||dc|| at or below this skip "
                         "the power iteration (reuse previous sigma_sq)")
    ap.add_argument("--engine", default="agd",
                    choices=["agd", "pdhg", "auto"],
                    help="solver engine for every tenant, or 'auto' for the "
                         "per-tenant adaptive selector; the routed engine "
                         "shows up in each solve_report")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="cross-check warm vs cold and batched vs sequential")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist all tenant sessions after each cadence")
    ap.add_argument("--resume", action="store_true",
                    help="restore from the latest checkpoint in "
                         "--checkpoint-dir; the first solve resumes warm")
    ap.add_argument("--dry-run", action="store_true",
                    help="build the fleet and ingest one delta per tenant "
                         "(print scatter-plan sizes) without solving")
    ap.add_argument("--metrics-out", default=None,
                    help="append telemetry JSONL records here "
                         "(schema: repro_torch.telemetry.SCHEMA)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace-event (Perfetto) span file")
    ap.add_argument("--prom-out", default=None,
                    help="write a Prometheus text-exposition snapshot")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


@dataclasses.dataclass
class ServiceRun:
    """What one run did, for callers that drive the CLI in process."""

    scheduler: object
    cadences: list  # (cadence index, CadenceReport, wall seconds)
    resumed_from: Optional[int]
    verify: Optional[dict]
    code: int  # the exit code


def run(args) -> ServiceRun:
    """The CLI's run, printing what the reference prints."""
    import numpy as np
    import torch

    from repro_torch import telemetry
    from repro_torch.core import MaximizerConfig
    from repro_torch.device import resolve_device
    from repro_torch.instances import MatchingInstanceSpec, generate_matching_instance
    from repro_torch.service import (
        BatchedSolvePool,
        Scheduler,
        ServiceConfig,
        compiled_solver,
        device_put_instance,
        instance_nbytes,
        shape_signature,
        to_solve_result,
    )

    device = resolve_device(args.device)
    if args.trace_out and not telemetry.get_tracer().recording:
        # the process default records nothing: record from the first cadence
        telemetry.set_tracer(telemetry.Tracer())
    rng = np.random.default_rng(args.seed)
    spec = MatchingInstanceSpec(
        num_sources=args.sources,
        num_destinations=args.destinations,
        avg_degree=args.avg_degree,
        num_families=args.families,
        seed=args.seed,
    )
    base = generate_matching_instance(spec)
    print(f"base instance: {base.nnz} nnz, dual_dim={spec.num_families * args.destinations}")

    cfg = ServiceConfig(
        cold=MaximizerConfig(
            iters_per_stage=args.iters_per_stage,
            tol_grad=args.tol_grad,
            tol_viol=args.tol_viol,
        ),
        drift_sla_rel=args.drift_sla,
        row_headroom=args.row_headroom,
        fused_oracle=args.fused_oracle,
        sigma_reuse_dc_threshold=args.sigma_reuse_threshold,
        engine=args.engine,
    )
    sched = Scheduler(cfg, device=device)

    sink = telemetry.JsonlSink(args.metrics_out) if args.metrics_out else None

    def emit_ingest(name, rep):
        if sink is None or rep is None:
            return
        sink.emit("ingest", {
            "tenant": name,
            "in_place": rep.in_place,
            "n_insert": rep.n_insert,
            "n_delete": rep.n_delete,
            "n_update": rep.n_update,
            "rebucketized": rep.rebucketized,
            "plan_cells": None if rep.plan is None else rep.plan.num_cells,
            "plan_bytes": None if rep.plan is None else rep.plan.nbytes,
        })

    def emit_cadence(cadence, out, wall):
        if sink is None:
            return
        n = len(out.reports)
        n_batched = sum(len(g) for g in out.batched_groups)
        sink.emit("cadence", {
            "cadence": cadence,
            "tenants": n,
            "batched_fraction": (n_batched / n) if n else 0.0,
            "upload_bytes": sum(
                r["upload_bytes"] or 0 for r in out.reports.values()
            ),
            "overlapped": False,
            "wall_seconds": wall,
        })
        for name in sorted(out.reports):
            r = out.reports[name]
            sink.emit(
                "solve_report",
                {k: v for k, v in r.items() if k != "convergence"},
            )
            if r.get("convergence"):
                sink.emit("convergence", r["convergence"])
        for name, rep in out.ingest.items():
            emit_ingest(name, rep)

    def export_telemetry():
        if sink is not None:
            sink.emit_counters()
            sink.close()
            print(f"telemetry: metrics JSONL appended to {args.metrics_out}")
        if args.trace_out:
            telemetry.get_tracer().export_chrome_trace(args.trace_out)
            print(f"telemetry: chrome trace written to {args.trace_out}")
        if args.prom_out:
            telemetry.write_prometheus(args.prom_out)
            print(f"telemetry: prometheus snapshot written to {args.prom_out}")

    mgr = None
    start_cadence = 0
    last = None
    if args.checkpoint_dir:
        from repro_torch.checkpoint import CheckpointManager, latest_step

        mgr = CheckpointManager(args.checkpoint_dir, keep=3)
        last = latest_step(args.checkpoint_dir) if args.resume else None
        if last is not None:
            sched.restore_checkpoint(mgr, last)
            start_cadence = last + 1
            print(
                f"resumed {len(sched.sessions)} tenants from "
                f"{args.checkpoint_dir}/step_{last:08d} — first solve is WARM"
            )
    if not sched.sessions:
        for t in range(args.tenants):
            sched.add_tenant(f"tenant{t}", base)

    if args.dry_run:
        for name, sess in sched.sessions.items():
            with telemetry.span("dry_run_ingest", tenant=name):
                rep = sess.ingest(
                    _random_delta(sess.ingestor.to_edge_list(), rng)
                )
            emit_ingest(name, rep)
            plan = rep.plan
            print(
                f"  {name}: delta +{rep.n_insert}/-{rep.n_delete}/~{rep.n_update}"
                f" -> plan cells={plan.num_cells} bytes={plan.nbytes}"
                f" (full slab upload would be "
                f"{instance_nbytes(sess.instance())}B)"
                if plan is not None
                else f"  {name}: re-bucketize fallback ({rep.fallback_reason})"
            )
        export_telemetry()
        print("DRY-RUN OK (no solves executed)")
        return ServiceRun(sched, [], last, None, 0)

    cadences = []
    for cadence in range(start_cadence, start_cadence + args.cadences):
        deltas = {}
        if cadence > 0:  # day 0 is the cold bootstrap of the shared topology
            for name, sess in sched.sessions.items():
                deltas[name] = _random_delta(sess.ingestor.to_edge_list(), rng)
        t0 = time.time()
        out = sched.run_cadence(deltas)
        dt = time.time() - t0
        cadences.append((cadence, out, dt))
        emit_cadence(cadence, out, dt)
        if mgr is not None:
            # async save: the write overlaps the next cadence; the final
            # mgr.wait() below keeps interpreter exit from killing the
            # daemon writer mid-checkpoint
            sched.save_checkpoint(mgr, cadence)
        n_batched = sum(len(g) for g in out.batched_groups)
        print(
            f"\ncadence {cadence}: {dt:.1f}s  "
            f"batched {n_batched}/{len(out.reports)} tenants "
            f"in {len(out.batched_groups)} batched call(s), "
            f"solo={out.solo_tenants}"
        )
        for name in sorted(out.reports):
            r = out.reports[name]
            ing = out.ingest.get(name)
            ing_s = (
                ""
                if ing is None
                else f"  delta[{'in-place' if ing.in_place else 'REPACK'}"
                f" +{ing.n_insert}/-{ing.n_delete}/~{ing.n_update}]"
            )
            drift = (
                "drift n/a"
                if r["drift_rel"] is None
                else f"drift_rel={r['drift_rel']:.3e} "
                f"(bound {r['drift_bound']:.2e}) sla_ok={r['sla_ok']}"
            )
            sigma_s = " sigma[reused]" if r.get("sigma_reused") else ""
            print(
                f"  {name}: {r['mode']:4s} [{r['engine']}] "
                f"iters {r['iters_used']}/{r['iter_budget']}"
                f" g={r['g']:.4f} viol={r['max_violation']:.2e} "
                f"up[{r['upload_mode']}:{r['upload_bytes']}B] {drift}{sigma_s}{ing_s}"
            )

    if mgr is not None:
        mgr.wait()  # flush the last async checkpoint before exiting

    export_telemetry()

    if not args.verify:
        return ServiceRun(sched, cadences, last, None, 0)
    print("\n-- verify: warm+early-stop vs cold full budget ----------------")
    sess = sched.sessions["tenant0"]
    inst = device_put_instance(sess.instance(), device)
    warm_r = sess.last_report
    full_cfg = MaximizerConfig(iters_per_stage=args.iters_per_stage)
    # the cold reference runs on the engine that served the warm cadence:
    # the agd and pdhg objectives differ by O(gamma)
    verify_engine = warm_r["engine"]
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)  # noqa: E731
    cold = to_solve_result(
        compiled_solver(full_cfg, cfg.normalize, engine=verify_engine)(
            inst, zeros(inst.dual_dim)
        )
    )
    g_rel = abs(warm_r["g"] - float(cold.g)) / max(abs(float(cold.g)), 1e-9)
    print(
        f"  cold: [{verify_engine}] iters {full_cfg.total_iters} "
        f"g={float(cold.g):.4f} "
        f"viol={float(cold.stats[-1].max_violation[-1]):.2e}"
    )
    print(
        f"  warm: iters {warm_r['iters_used']} g={warm_r['g']:.4f} "
        f"viol={warm_r['max_violation']:.2e}  rel-dg={g_rel:.2e}"
    )
    ok_g = g_rel < 1e-3
    ok_iters = warm_r["iters_used"] < full_cfg.total_iters
    print(f"  same-quality={ok_g} fewer-iters={ok_iters}")

    print("-- verify: batched pool vs sequential -------------------------")
    insts = [device_put_instance(s.instance(), device) for s in sched.sessions.values()]
    sig = {shape_signature(i) for i in insts}
    pool_res = BatchedSolvePool(cfg.cold, normalize=cfg.normalize).solve(insts)
    seq_fn = compiled_solver(cfg.cold, cfg.normalize)
    max_rel = 0.0
    for i, inst_i in enumerate(insts):
        seq = to_solve_result(seq_fn(inst_i, zeros(inst_i.dual_dim)))
        max_rel = max(
            max_rel,
            abs(float(pool_res[i].g) - float(seq.g))
            / max(abs(float(seq.g)), 1e-9),
        )
    print(
        f"  {len(insts)} tenants, {len(sig)} shape signature(s), "
        f"max rel objective diff batched-vs-seq: {max_rel:.2e}"
    )
    verify = {"warm_vs_cold_rel_g": g_rel, "warm_iters": warm_r["iters_used"],
              "cold_iters": full_cfg.total_iters, "batched_vs_seq_rel_g": max_rel,
              "signatures": len(sig)}
    if not (ok_g and ok_iters and max_rel < 1e-3 and len(sig) == 1):
        print("VERIFY FAILED")
        return ServiceRun(sched, cadences, last, {**verify, "ok": False}, 1)
    print("VERIFY OK")
    return ServiceRun(sched, cadences, last, {**verify, "ok": True}, 0)


def main(argv: Optional[list[str]] = None) -> int:
    return run(build_parser().parse_args(argv)).code


if __name__ == "__main__":
    raise SystemExit(main())
