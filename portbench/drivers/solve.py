"""One-shot cold solves back to back (closed loop): the paper's main path as
`repro_torch.launch.solve` composes it.

Set-up generates the instance, packs it (`bucketize`), Jacobi-normalizes it
on the host (`normalize_rows`), compiles the matching formulation and builds
its objective, then solves once to build the kernel and its plan.  The
window runs `Maximizer(objective, config).solve()` from zero duals, each
ending synchronised.  Afterwards the reference solves the same edge list and
judges every solve's duals and dual objective, and the primal of one solve
drawn from the seed, and the packed, normalized slabs the solves read.
"""
from __future__ import annotations

import torch

from portbench import port, trace
from portbench.generator import generate, rng_for
from portbench.reference import judge
from portbench.reference.matching import RefInstance, agd, oracle, power_iteration


def run(ctx) -> dict:
    from repro_torch.core import Maximizer, MaximizerConfig, normalize_rows
    from repro_torch.formulation import scenario_formulation
    from repro_torch.instances import bucketize

    ctx.part("import")
    cfg, tr = ctx.config, ctx.traffic
    if ctx.device.startswith("cuda"):
        with ctx.setup("cuda_context"):
            torch.empty(1, device=ctx.device)
    with ctx.setup("generate"):
        edges = generate(cfg, ctx.seed, ctx.device)
    with ctx.setup("pack"):
        packed = bucketize(port.edge_list(edges, cfg), dtype=ctx.slab_dtype,
                           device=ctx.device)
    with ctx.setup("normalize"):
        scaled, _ = normalize_rows(packed)
        del packed
        objective = scenario_formulation("matching").compile(scaled).objective(
            fused_oracle=True)
    mcfg = MaximizerConfig(gammas=tuple(tr["gammas"]), iters_per_stage=tr["iters_per_stage"],
                           power_iters=tr["power_iters"])
    with ctx.setup("build"):
        ctx.build_kernels(["dual_oracle"])
    with ctx.setup("warmup"):
        Maximizer(objective, mcfg).solve()

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
        def stretch():
            for _ in range(tr["profiled_units"]):
                Maximizer(objective, mcfg).solve()
                ctx.sync()
        data = {"profiled": trace.profile(stretch, tr["profiled_units"], ctx.sync),
                "shapes": port.shapes(scaled), "solve_s": elapsed / n,
                "oracle_calls": mcfg.total_iters + 1, "power_steps": mcfg.power_iters}
    del objective

    # the reference, on what the window produced
    dev = ctx.device
    ref, _ = RefInstance.build(edges.num_sources, edges.num_destinations, edges.num_families,
                               edges.src, edges.dst, edges.values, edges.coeff, edges.rhs,
                               dev).scaled()
    sigma_sq = power_iteration(ref, mcfg.seed, mcfg.power_iters)
    lam_ref, g_ref, _ = agd(ref, torch.zeros(ref.m * ref.J, dtype=torch.float64, device=dev),
                        mcfg.gammas, mcfg.iters_per_stage, sigma_sq)
    gamma = mcfg.gammas[-1]
    lam_gap = g_gap = g_at_gap = 0.0
    failed = 0
    for i, (lam, g) in enumerate(outs):
        if not bool(torch.isfinite(lam).all()):
            failed += 1
        lam_gap = max(lam_gap, judge.rel_l2(lam, lam_ref))
        g_at, _, x_at = oracle(ref, lam.double().to(dev), gamma)
        g_at_gap = max(g_at_gap, abs(float(g) - float(g_at)) / abs(float(g_at)))
        g_gap = max(g_gap, abs(float(g) - float(g_ref)) / abs(float(g_ref)))
        if i == kept["at"]:
            x_want = x_at
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
