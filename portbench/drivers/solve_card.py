"""One-shot cold solves back to back (closed loop) at the paper's per-card
size: the main path as `repro_torch.launch.solve` composes it on one card,
with the edge list packed and Jacobi-scaled on the card.

Set-up generates the instance (`portbench.generator`, the other cells'
draws), moves the edge list to the card, packs it there (`bucketize`, span
`pack`), scales it there (`normalize_rows`, span `normalize`), builds the
fused objective and solves once with one iteration a stage.  The window runs
`Maximizer(objective, config).solve()` from zero duals, each ending
synchronised.  With `--trace 1` a tracer records set-up and the window, and
the trace carries the set-up spans' device times beside what
`drivers/solve.py` hands its readers.

Afterwards the objective is freed and the degree-grouped float64 reference
(`reference/matching_grouped.py`) solves the same edge list; it judges every
solve's dual objective, the primal of one solve drawn from the seed, and the
packed, scaled slabs the solves read.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench import port, trace
from portbench.generator import generate, rng_for
from portbench.reference import judge
from portbench.reference.matching_grouped import GroupedInstance, agd, oracle, power_iteration

SETUP_SPANS = ("pack", "normalize")


def run(ctx) -> dict:
    from repro_torch import telemetry
    from repro_torch.core import Maximizer, MaximizerConfig, normalize_rows
    from repro_torch.formulation import scenario_formulation
    from repro_torch.instances import EdgeListInstance, bucketize

    if not hasattr(EdgeListInstance, "to"):
        # a program that packs on the host would take minutes at this size
        raise RuntimeError("this program cannot move an edge list to the card "
                           "(no EdgeListInstance.to), so it cannot pack there")
    ctx.part("import")
    cfg, tr = ctx.config, ctx.traffic
    if ctx.trace:
        untraced = telemetry.set_tracer(telemetry.Tracer())
    if ctx.device.startswith("cuda"):
        with ctx.setup("cuda_context"):
            torch.empty(1, device=ctx.device)
    with ctx.setup("generate"):
        edges = generate(cfg, ctx.seed, ctx.device)
    with ctx.setup("upload"):
        on_card = port.edge_list(edges, cfg).to(ctx.device)
    with ctx.setup("pack"):
        packed = bucketize(on_card, dtype=ctx.slab_dtype, device=ctx.device)
        del on_card
    with ctx.setup("normalize"):
        scaled, _ = normalize_rows(packed)
        del packed
    with ctx.setup("objective"):
        objective = scenario_formulation("matching").compile(scaled).objective(
            fused_oracle=True)
    mcfg = MaximizerConfig(gammas=tuple(tr["gammas"]), iters_per_stage=tr["iters_per_stage"],
                           power_iters=tr["power_iters"])
    with ctx.setup("build"):
        ctx.build_kernels(["dual_oracle"])
    with ctx.setup("warmup"):
        # the window's work at its shapes: the power iteration and the
        # oracle in every stage, one iteration a stage
        Maximizer(objective, dataclasses.replace(mcfg, iters_per_stage=1)).solve()

    sample = int(rng_for(ctx.seed, 2).integers(0, tr["sample_within"]))
    kept = {}

    def step(i):
        res = Maximizer(objective, mcfg).solve()
        ctx.sync()
        if i <= sample:
            kept["x"], kept["at"] = res.x_slabs, i
        return res.lam, res.g

    outs, elapsed = ctx.closed_loop(step)
    n = len(outs)
    data = None
    if ctx.trace:
        spans = {}
        for e in telemetry.get_tracer().events():
            if e["name"] in SETUP_SPANS:
                spans[e["name"]] = {"host_ms": e["dur"] / 1e3,
                                    "device_ms": e["args"].get("device_ms")}
        telemetry.set_tracer(telemetry.Tracer(profiler_annotations=True))

        def stretch():
            for _ in range(tr["profiled_units"]):
                Maximizer(objective, mcfg).solve()
                ctx.sync()
        data = {"profiled": trace.profile(stretch, tr["profiled_units"], ctx.sync),
                "shapes": port.shapes(scaled), "solve_s": elapsed / n,
                "oracle_calls": mcfg.total_iters + 1, "power_steps": mcfg.power_iters,
                "setup_spans": spans}
        telemetry.set_tracer(untraced)
    del objective

    # the reference, on what the window produced
    dev = ctx.device
    ref, _ = GroupedInstance.build(edges.num_sources, edges.num_destinations,
                                   edges.num_families, edges.src, edges.dst, edges.values,
                                   edges.coeff, edges.rhs, dev).scaled()
    sigma_sq = power_iteration(ref, mcfg.seed, mcfg.power_iters)
    lam_ref, g_ref, _ = agd(ref, torch.zeros(ref.m * ref.J, dtype=torch.float64, device=dev),
                            mcfg.gammas, mcfg.iters_per_stage, sigma_sq)
    gamma = mcfg.gammas[-1]
    lam_gap = g_gap = g_at_gap = 0.0
    failed = 0
    x_want = None
    for i, (lam, g) in enumerate(outs):
        if not bool(torch.isfinite(lam).all()):
            failed += 1
        lam_gap = max(lam_gap, judge.rel_l2(lam, lam_ref))
        g_at, _, x_at = oracle(ref, lam.double().to(dev), gamma)
        g_at_gap = max(g_at_gap, abs(float(g) - float(g_at)) / abs(float(g_at)))
        g_gap = max(g_gap, abs(float(g) - float(g_ref)) / abs(float(g_ref)))
        if i == kept["at"]:
            x_want = x_at
        del x_at
    mismatch, scale_gap, x_got = judge.slab_numbers(
        port.program_slabs(scaled, scaled.pack_info.source_ids, kept["x"]), ref, scaled.rhs,
        width=getattr(torch, cfg["slab_dtype"]), exact=False)
    x_gap = judge.x_gap(x_got, x_want) if x_got is not None else float("inf")
    return {
        "attempted": n, "failed": failed,
        "metrics": {"solve_s": elapsed / n},
        "checks": {"slab_mismatch": mismatch, "scale_gap": scale_gap, "x_gap": x_gap,
                   "g_at_gap": g_at_gap, "g_gap": g_gap, "lam_gap": lam_gap},
        "trace": data,
    }
