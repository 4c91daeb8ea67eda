"""Recurring cadences of one tenant back to back (closed loop), through
`repro_torch.service.Scheduler.run_cadence`: ingest the delta on the host
slabs, replay its scatter plan on the device copy, solve warm, absorb.

Set-up generates the instance, registers the tenant (the `DeltaIngestor`
packs it with row headroom), runs the cold first cadence (the whole gamma
schedule from zero duals), makes the pool of deltas, and runs one warm
cadence.  The window then runs one warm cadence per delta of the pool; a
window that would need more deltas than the pool holds fails the run.

Afterwards the reference applies the same deltas to its own edge list and
judges the device instance that the last cadence solved (every slot, exact),
the cold cadence's duals against its own cold solve, and the duals and dual
objective of cadences drawn from the seed against its own warm solve from
the duals that the program started that cadence from.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import port, trace
from portbench.generator import delta_pool, generate, rng_for
from portbench.reference import judge
from portbench.reference.matching import EdgeState, agd, oracle, power_iteration


class _PowerTimer:
    """Times each power iteration of the program: CUDA events around the
    call on the card (host clock on the CPU), read after the window."""

    def __init__(self, cls, on_card: bool):
        self.cls, self.orig, self.marks, self.on_card = cls, cls.power_iteration, [], on_card
        timer = self

        def timed(obj, *a, **k):
            if timer.on_card:
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                out = timer.orig(obj, *a, **k)
                e.record()
            else:
                s = time.perf_counter()
                out = timer.orig(obj, *a, **k)
                e = time.perf_counter()
            timer.marks.append((s, e))
            return out

        cls.power_iteration = timed

    def close(self) -> float:
        self.cls.power_iteration = self.orig
        if self.on_card:
            return sum(s.elapsed_time(e) for s, e in self.marks)
        return sum(e - s for s, e in self.marks) * 1e3


def _sources(ingestor, buckets) -> list:
    """The source of each slab row, from the ingestor's row map."""
    out = []
    for t, b in enumerate(buckets):
        sid = np.full(b.rows, -1, np.int64)
        mine = np.flatnonzero(ingestor.bucket_of == t)
        sid[ingestor.row_of[mine]] = mine
        out.append(sid)
    return out


def run(ctx) -> dict:
    from repro_torch import telemetry
    from repro_torch.core import MaximizerConfig
    from repro_torch.core import objective as program_objective
    from repro_torch.service import Scheduler, ServiceConfig

    ctx.part("import")
    cfg, tr = ctx.config, ctx.traffic
    if ctx.device.startswith("cuda"):
        with ctx.setup("cuda_context"):
            torch.empty(1, device=ctx.device)
    with ctx.setup("generate"):
        edges = generate(cfg, ctx.seed, ctx.device)
    cold = MaximizerConfig(gammas=tuple(tr["cold_gammas"]), iters_per_stage=tr["iters_per_stage"],
                           power_iters=tr["power_iters"])
    service = ServiceConfig(cold=cold, warm_gammas=tuple(tr["warm_gammas"]),
                            fused_oracle=True, row_headroom=tr["row_headroom"],
                            slab_dtype=ctx.slab_dtype)
    sched = Scheduler(service, device=ctx.device)
    with ctx.setup("pack"):
        session = sched.add_tenant("t0", port.edge_list(edges, cfg))
    with ctx.setup("build"):
        ctx.build_kernels(["dual_oracle"])
    with ctx.setup("warmup"):
        g_cold = sched.run_cadence({}).reports["t0"]["g"]
        lam_cold = session.lam_prev.clone()
    count = int(math.ceil(ctx.seconds / tr["pool_cadence_s"])) + 1 + tr["profiled_units"]
    with ctx.setup("pool"):
        pool = delta_pool(edges, tr, ctx.seed, count)
        deltas = [port.instance_delta(d) for d in pool]
    with ctx.setup("warmup"):
        sched.run_cadence({"t0": deltas[0]})
        lams = [session.lam_prev.clone()]  # the duals each cadence starts from, in turn

    timer = None
    if ctx.trace:
        telemetry.set_tracer(telemetry.Tracer())
        timer = _PowerTimer(program_objective.MatchingObjective, ctx.device.startswith("cuda"))
    limit = count - tr["profiled_units"]
    fallbacks = 0

    def step(i):
        nonlocal fallbacks
        if i + 1 >= limit:
            raise RuntimeError(f"the pool of {count} deltas is exhausted after {i} cadences")
        out = sched.run_cadence({"t0": deltas[i + 1]})
        ctx.sync()
        fallbacks += bool(out.ingest["t0"].rebucketized)
        lams.append(session.lam_prev.clone())
        return out.reports["t0"]["g"]

    gs, elapsed = ctx.closed_loop(step)
    n = len(gs)
    data = None
    if ctx.trace:
        power_ms = timer.close()
        events = telemetry.get_tracer().events()
        spans = {}
        for e in events:
            spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e3
        telemetry.set_tracer(telemetry.Tracer(profiler_annotations=True))

        def stretch():
            for k in range(tr["profiled_units"]):
                sched.run_cadence({"t0": deltas[n + 1 + k]})
                ctx.sync()
        data = {"profiled": trace.profile(stretch, tr["profiled_units"], ctx.sync),
                "span_ms": spans, "span_units": sum(e["name"] == "cadence" for e in events),
                "power_iteration_ms": power_ms, "units": n, "fallbacks": fallbacks}
    applied = n + 1 + (tr["profiled_units"] if ctx.trace else 0)
    final = session.device_instance()
    got = port.program_slabs(final, _sources(session.ingestor, final.buckets))
    final_rhs = final.rhs
    del sched

    # the reference, on what the window produced
    dev = ctx.device
    I, J, m = edges.num_sources, edges.num_destinations, edges.num_families
    state = EdgeState(I, J, m, edges.src, edges.dst, edges.values, edges.coeff, edges.rhs)
    base, _ = state.instance(dev).scaled()
    sigma_sq = power_iteration(base, cold.seed, cold.power_iters)
    lam_ref, g_ref, _ = agd(base, torch.zeros(m * J, dtype=torch.float64, device=dev),
                            cold.gammas, cold.iters_per_stage, sigma_sq)
    lam_gap_cold = judge.rel_l2(lam_cold, lam_ref)
    g_gap_cold = abs(g_cold - float(g_ref)) / abs(float(g_ref))
    g_at, _, _ = oracle(base, lam_cold.double().to(dev), cold.gammas[-1])
    g_at_gap = abs(g_cold - float(g_at)) / abs(float(g_at))
    del base

    picks = rng_for(ctx.seed, 3).permutation(max(n - 1, 0))[: tr["checked_cadences"] - 1]
    checked = sorted({int(i) for i in picks} | {n - 1})
    warm, gamma = tuple(tr["warm_gammas"]), tr["warm_gammas"][-1]
    lam_gap_warm = g_gap_warm = 0.0
    done = 0
    for i in checked:  # window cadence i solved after deltas 0..i+1
        while done < i + 2:
            state.apply(pool[done])
            done += 1
        inst, _ = state.instance(dev).scaled()
        sigma_sq = power_iteration(inst, cold.seed, cold.power_iters)
        lam_i, g_i, _ = agd(inst, lams[i].to(dev), warm, tr["iters_per_stage"], sigma_sq)
        lam_gap_warm = max(lam_gap_warm, judge.rel_l2(lams[i + 1], lam_i))
        g_gap_warm = max(g_gap_warm, abs(gs[i] - float(g_i)) / abs(float(g_i)))
        g_at, _, _ = oracle(inst, lams[i + 1].double().to(dev), gamma)
        g_at_gap = max(g_at_gap, abs(gs[i] - float(g_at)) / abs(float(g_at)))
    while done < applied:
        state.apply(pool[done])
        done += 1
    ref = state.instance(dev)
    mismatch, _, _ = judge.slab_numbers(got, ref, final_rhs,
                                        width=getattr(torch, cfg["slab_dtype"]), exact=True)
    return {
        "attempted": n, "failed": 0,
        "metrics": {"cadence_s": elapsed / n},
        "checks": {"slab_mismatch": mismatch, "g_gap_cold": g_gap_cold,
                   "g_gap_warm": g_gap_warm, "g_at_gap": g_at_gap,
                   "lam_gap_cold": lam_gap_cold, "lam_gap_warm": lam_gap_warm},
        "trace": data,
    }
