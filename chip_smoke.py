#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py [--sources 1000000]

Phases, each printing one line before the last:
  1. device: name, count, and `nvidia-smi` name and power limit;
  2. build: the three hand-written kernels from src/repro_torch/kernels/csrc,
     one nvcc each, all started together;
  3. sweep: the dual-oracle kernel against its plain PyTorch version on the
     card over widths, families, slab dtypes, gammas and both simplex
     variants, padded rows and repeated idx included; then bitwise
     run-to-run equality of the kernel;
     sweep2 / sweep3: the primal-step and simplex kernels the same way over
     every power-of-two width up to 8192, two radii included, with the
     primal kernel's x held bitwise equal to the oracle's, and the primal
     kernel also at m*J past shared memory (lam read through L1/L2);
  4. main path: the one-shot fused-oracle AGD solve of
     `python -m repro_torch.launch.solve` in-process at 1M sources x 10k
     destinations, with the kernel's launch count checked against
     buckets x oracle calls, fused-vs-plain `calculate` at the final and at
     random duals, and a small solve on the card against the same on the CPU;
     path2: the same instance solved by `DistributedMaximizer` (world size
     1 over NCCL) with the fused primal kernel, against the main path and
     the single-device solve;
     path3: the same instance solved with the simplex kernel as the unfused
     oracle's projection, against the same solve with the plain projection;
     two_ranks: a small sharded solve in two processes sharing the card
     over gloo, against one process;
  5. times: each kernel's output at the main path's shapes held against
     its plain version; each kernel, its plain version and its HBM bound
     there, by CUDA events; the all-reduce of the sharded solve at
     world size 1; and the device's busy share over a profiled window of
     AGD iterations (torch.profiler).
Every path is driven with all launch counters set to 0 just before it and
read just after.  The line before the last is the JSON list of kernels; the
last line is {"ok": true, "device": {...}}.  Any failed check exits
non-zero without it.  Imports torch, numpy and the port; nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
KERNELS = ("dual_oracle", "dual_primal", "simplex_proj")
X_ATOL = {"float32": 3e-5, "bfloat16": 2e-2, "int8": 3e-5}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


T0 = time.perf_counter()


def timed(fn, *args):
    """`fn(*args)`, its start and end logged to stderr with the seconds
    since the script started."""
    print(f"chip_smoke: {fn.__name__} at {time.perf_counter() - T0:.1f} s",
          file=sys.stderr, flush=True)
    out = fn(*args)
    print(f"chip_smoke: {fn.__name__} done at {time.perf_counter() - T0:.1f} s",
          file=sys.stderr, flush=True)
    return out


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def reset_counts() -> None:
    """Every kernel's launch counter and the width rule's to 0."""
    from repro_torch.kernels import dual_oracle, dual_primal, ops, simplex_proj

    dual_oracle.launches = dual_primal.launches = simplex_proj.launches = 0
    ops.width_routed = 0


def read_counts() -> dict:
    from repro_torch.kernels import dual_oracle, dual_primal, ops, simplex_proj

    return {"dual_oracle": dual_oracle.launches, "dual_primal": dual_primal.launches,
            "simplex_proj": simplex_proj.launches, "width_routed": ops.width_routed}


def held(got, want, atol: float) -> tuple[float, bool]:
    """Max |got - want| and bitwise equality; fails beyond `atol`."""
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.dtype != want.dtype or not err <= atol:
        fail(f"{got.dtype} against {want.dtype}: max error {err} > {atol}")
    return err, bool(torch.equal(got, want))


def rel_l2(a, b) -> float:
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-12))


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def random_bucket(rng, n, L, m, J, dtype, device, padded_rows):
    """Random slab (repeated idx within rows, padded rows) in a storage dtype."""
    import numpy as np
    import torch

    from repro_torch.instances.buckets import Bucket, convert_bucket

    mask = (rng.random((n, L)) < 0.8).astype(np.float32)
    mask[:padded_rows] = 0.0
    idx = (rng.integers(0, J, size=(n, L)) * mask).astype(np.int32)
    coeff = (rng.random((m, n, L)) * mask[None]).astype(np.float32)
    cost = (rng.normal(size=(n, L)) * mask).astype(np.float32)
    b = Bucket(idx=torch.from_numpy(idx), coeff=torch.from_numpy(coeff),
               cost=torch.from_numpy(cost), mask=torch.from_numpy(mask), length=L)
    lam = torch.from_numpy(rng.random(m * J).astype(np.float32)).to(device)
    return convert_bucket(b, dtype).to(device), lam


def oracle_args(b, lam, gamma, J, inequality):
    return (b.idx, b.coeff, b.cost, b.mask, lam, gamma), dict(
        num_destinations=J, radius=1.0, inequality=inequality,
        coeff_scale=b.coeff_scale, cost_scale=b.cost_scale,
    )


def phase_sweep(device) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import dual_oracle as kdo
    from repro_torch.kernels import ref as kref

    x_atol = X_ATOL
    worst = {d: {"x": 0.0, "partials": 0.0} for d in x_atol}
    cases = exact = 0
    bad = []
    rng = np.random.default_rng(0)
    shapes = [(L, 1000 if L <= 64 else (37 if L <= 512 else 9), 64)
              for L in (1, 4, 8, 16, 32, 64, 512, 8192)]
    shapes += [(8, 20000, 10000), (16, 3000, 40000)]  # lam in smem / in L2
    for L, n, J in shapes:
        for m in ((1, 3) if J == 64 else (1,)):
            for dtype in x_atol:
                b, lam = random_bucket(rng, n, L, m, J, dtype, device, 5)
                for gamma in (0.01, 1.0, 100.0):
                    for inequality in (True, False):
                        args, kw = oracle_args(b, lam, gamma, J, inequality)
                        x, hist_p, scal_p = kdo.dual_oracle(*args, **kw)
                        got = (x, hist_p.sum(0), scal_p[:, 0].sum(), scal_p[:, 1].sum())
                        want = kref.dual_oracle_ref(*args[:6], J, **{
                            k: v for k, v in kw.items() if k != "num_destinations"})
                        torch.cuda.synchronize()
                        tag = f"L={L} n={n} J={J} m={m} {dtype} gamma={gamma} ineq={inequality}"
                        if x.dtype != want[0].dtype:
                            bad.append(f"x dtype {x.dtype} != {want[0].dtype} ({tag})")
                        ex = float((x.float() - want[0].float()).abs().max())
                        if not ex <= x_atol[dtype]:
                            bad.append(f"x max error {ex} > {x_atol[dtype]} ({tag})")
                        if float(x[:5].float().abs().max()) != 0.0:
                            bad.append(f"padded rows not exactly zero ({tag})")
                        for a, w, name in zip(got[1:], want[1:], ("hist", "lin", "sq")):
                            err = (a - w).abs()
                            if not bool((err <= 3e-5 + 1e-5 * w.abs()).all()):
                                bad.append(f"{name} max error {float(err.max())} ({tag})")
                            worst[dtype]["partials"] = max(
                                worst[dtype]["partials"], float(err.max()))
                        worst[dtype]["x"] = max(worst[dtype]["x"], ex)
                        exact += int(torch.equal(x, want[0]))
                        cases += 1
    if bad:
        fail(f"{len(bad)} of {cases} sweep cases out of tolerance: {bad[:8]}")
    # run-to-run: the same input twice gives bitwise the same outputs
    b, lam = random_bucket(rng, 4000, 32, 3, 64, "float32", device, 5)
    args, kw = oracle_args(b, lam, 1.0, 64, True)
    first, second = kdo.dual_oracle(*args, **kw), kdo.dual_oracle(*args, **kw)
    bitwise = all(torch.equal(a, c) for a, c in zip(first, second))
    if not bitwise:
        fail("kernel outputs differ between two calls on one input")
    out = {"phase": "sweep", "cases": cases, "x_bitwise_equal_cases": exact,
           "worst_abs_err": worst,
           "bitwise_equal_rerun": bitwise}
    emit(out)
    return out


def sweep_rows(L: int) -> int:
    return 1000 if L <= 64 else (37 if L <= 512 else 9)


def phase_sweep2(device) -> dict:
    """The primal-step kernel against its plain version and the oracle, and
    at m*J past shared memory (lam read through L1/L2) against its plain
    version alone: the oracle's histogram does not fit there."""
    import numpy as np
    import torch

    from repro_torch.kernels import dual_oracle as kdo
    from repro_torch.kernels import dual_primal as kdp
    from repro_torch.kernels import ref as kref

    worst = {d: 0.0 for d in X_ATOL}
    counts = {"cases": 0, "exact_plain": 0, "exact_oracle": 0, "lam_in_l2": 0}
    bad = []
    rng = np.random.default_rng(1)
    num_sms = torch.cuda.get_device_properties(device).multi_processor_count

    def check(L, n, m, J, with_oracle):
        for dtype in X_ATOL:
            b, lam = random_bucket(rng, n, L, m, J, dtype, device, 5)
            for gamma, radius in ((0.01, 1.0), (1.0, 1.0), (100.0, 2.5)):
                for inequality in (True, False):
                    args, kw = oracle_args(b, lam, gamma, J, inequality)
                    kw["radius"] = radius
                    x = kdp.dual_primal(*args, **kw)
                    want = kref.dual_primal_ref(*args[:6], J, **{
                        k: v for k, v in kw.items() if k != "num_destinations"})
                    oracle_x = kdo.dual_oracle(*args, **kw)[0] if with_oracle else None
                    torch.cuda.synchronize()
                    tag = (f"L={L} m={m} J={J} {dtype} gamma={gamma} r={radius} "
                           f"ineq={inequality}")
                    err = float((x.float() - want.float()).abs().max())
                    if x.dtype != want.dtype or not err <= X_ATOL[dtype]:
                        bad.append(f"x {x.dtype} max error {err} ({tag})")
                    if float(x[:5].float().abs().max()) != 0.0:
                        bad.append(f"padded rows not exactly zero ({tag})")
                    worst[dtype] = max(worst[dtype], err)
                    counts["exact_plain"] += int(torch.equal(x, want))
                    if with_oracle:
                        counts["exact_oracle"] += int(torch.equal(x, oracle_x))
                    else:
                        counts["lam_in_l2"] += 1
                    counts["cases"] += 1

    for L in (1 << k for k in range(14)):
        for m in (1, 2, 3):
            check(L, sweep_rows(L), m, 64, True)
    for L, n, m, J in ((16, 3000, 1, 70_000), (256, 37, 3, 20_000)):
        if kdp.plan_launch(n, L, m, J, num_sms).lam_in_smem:
            fail(f"primal kernel plans lam in shared memory at L={L} m={m} J={J}")
        check(L, n, m, J, False)
    cases, oracle_cases = counts["cases"], counts["cases"] - counts["lam_in_l2"]
    out = {"phase": "sweep2", "cases": cases, "lam_in_l2_cases": counts["lam_in_l2"],
           "worst_abs_err": worst,
           "x_bitwise_equal_plain_cases": counts["exact_plain"],
           "x_bitwise_equal_oracle_cases": counts["exact_oracle"],
           "oracle_cases": oracle_cases}
    emit(out)
    if bad:
        fail(f"{len(bad)} of {cases} primal-kernel sweep cases out of tolerance: {bad[:8]}")
    if counts["exact_oracle"] != oracle_cases:
        fail(f"primal kernel's x bitwise equal to the oracle's in "
             f"{counts['exact_oracle']} of {oracle_cases} cases")
    return out


def phase_sweep3(device) -> dict:
    """The simplex kernel against its plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import simplex_proj as ksp

    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = exact = 0
    bad = []
    rng = np.random.default_rng(2)
    for L in (1 << k for k in range(14)):
        n = sweep_rows(L)
        v32 = torch.from_numpy((rng.normal(size=(n, L)) * 2).astype(np.float32))
        mask32 = torch.from_numpy((rng.random((n, L)) < 0.7).astype(np.float32))
        mask32[:5] = 0.0
        for dtype in worst:
            dt = getattr(torch, dtype)
            v, mask = v32.to(device, dt), mask32.to(device, dt)
            for radius in (1.0, 2.5):
                for inequality in (True, False):
                    got = ksp.simplex_proj(v, mask, radius, inequality=inequality)
                    want = kref.simplex_ref(v, mask, radius, inequality=inequality)
                    torch.cuda.synchronize()
                    tag = f"L={L} {dtype} r={radius} ineq={inequality}"
                    err = float((got.float() - want.float()).abs().max())
                    if got.dtype != dt or not err <= X_ATOL[dtype]:
                        bad.append(f"{got.dtype} max error {err} ({tag})")
                    if float(got[:5].float().abs().max()) != 0.0:
                        bad.append(f"padded rows not exactly zero ({tag})")
                    worst[dtype] = max(worst[dtype], err)
                    exact += int(torch.equal(got, want))
                    cases += 1
    out = {"phase": "sweep3", "cases": cases, "worst_abs_err": worst,
           "bitwise_equal_plain_cases": exact}
    emit(out)
    if bad:
        fail(f"{len(bad)} of {cases} simplex-kernel sweep cases out of tolerance: {bad[:8]}")
    return out


def phase_main_path(sources: int) -> dict:
    import torch

    from repro_torch.core import MatchingObjective
    from repro_torch.launch import solve

    args = solve.build_parser().parse_args([
        "--sources", str(sources), "--destinations", "10000",
        "--avg-degree", "8", "--families", "1", "--slab-dtype", "float32",
        "--fused-oracle", "--iters-per-stage", "100", "--device", "cuda",
    ])
    reset_counts()
    r = solve.run(args)
    counts = read_counts()
    launches, width_routed = counts["dual_oracle"], counts["width_routed"]
    inst = r.instance
    res = r.result
    calls = r.total_iters + 1  # every AGD iteration plus the final calculate
    expect = len(inst.buckets) * calls
    out = {
        "phase": "main_path", "sources": sources, "nnz": r.edges.nnz,
        "slots": sum(b.idx.numel() for b in inst.buckets),
        "buckets": [[b.length, b.rows] for b in inst.buckets],
        "iterations": r.total_iters, "setup_s": r.setup_s, "solve_s": r.solve_s,
        "ms_per_iter": r.solve_s / r.total_iters * 1e3,
        "g": float(res.g), "value": r.value, "max_violation": r.violation,
        "sigma_sq": float(res.sigma_sq),
        "kernel_launches": launches, "expected_launches": expect,
        "launch_counts": counts,
        "width_routed": width_routed,
    }
    # the fused kernel against the plain unfused oracle on the card.  Near
    # the optimum grad = Ax - b is a small difference of large terms, so at
    # the final duals its rel-L2 also measures the two fp32 summation orders
    # of A x (the segment sum against the kernel's histogram): that one is
    # reported, and held are g and A x there, and g and grad at random duals
    # in [0, 1) (the reference's parity test, tests/test_dual_oracle.py).
    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b).clamp_min(1e-12))

    checks = []
    gen = torch.Generator(device="cpu").manual_seed(0)
    lam_rand = torch.rand(inst.dual_dim, generator=gen).to(res.lam.device)
    for tag, lam, gamma in (("final", res.lam, r.config.gammas[-1]),
                            ("random", lam_rand, 1.0), ("random", lam_rand, 0.01)):
        fused = MatchingObjective(inst, fused_oracle=True).calculate(lam, gamma)
        plain = MatchingObjective(inst).calculate(lam, gamma)
        checks.append({
            "duals": tag, "gamma": gamma,
            "rel_g": abs(float(fused.g - plain.g)) / max(abs(float(plain.g)), 1e-12),
            "rel_ax": rel(fused.ax, plain.ax), "rel_grad": rel(fused.grad, plain.grad),
            "grad_over_ax": float(torch.linalg.vector_norm(plain.grad)
                                  / torch.linalg.vector_norm(plain.ax)),
        })
    out["fused_vs_plain"] = checks

    # a small solve through the kernel against the same solve on the CPU
    small = solve.build_parser().parse_args([
        "--sources", "2000", "--destinations", "50", "--iters-per-stage", "25",
        "--fused-oracle", "--device", "cuda",
    ])
    on_card = solve.run(small).result
    small.device = "cpu"
    on_cpu = solve.run(small).result
    lam_rel = rel(on_card.lam.cpu(), on_cpu.lam)
    g_rel = abs(float(on_card.g) - float(on_cpu.g)) / abs(float(on_cpu.g))
    out.update(small_solve_card_vs_cpu_rel_lam=lam_rel, small_solve_card_vs_cpu_rel_g=g_rel)
    emit(out)

    if launches != expect or counts["dual_primal"] or counts["simplex_proj"]:
        fail(f"kernel launches {counts} != buckets x oracle calls {expect} of the oracle")
    if width_routed != 0:
        fail(f"{width_routed} oracle calls left the kernel by the width rule")
    if not all(math.isfinite(out[k]) for k in ("g", "value", "max_violation")):
        fail(f"non-finite result {out}")
    for b, x in zip(inst.buckets, res.x_slabs):
        if tuple(x.shape) != tuple(b.cost.shape) or not bool(torch.isfinite(x).all()):
            fail("primal slab of the wrong shape or not finite")
    for c in checks:
        held = [c["rel_g"], c["rel_ax"]] + ([c["rel_grad"]] if c["duals"] == "random" else [])
        if not all(v <= 1e-5 for v in held):
            fail(f"fused vs plain calculate beyond 1e-5 rel: {c}")
    if not (lam_rel <= 1e-4 and g_rel <= 1e-5):
        fail(f"small solve on the card vs the CPU: rel lam {lam_rel}, rel g {g_rel}")
    return {"run": r, "summary": out}


def rel_diff(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def matched_value(r, x_slabs) -> float:
    import numpy as np

    from repro_torch.instances import unpack_primal

    return -float(np.dot(r.edges.cost, unpack_primal(r.instance, x_slabs)))


def phase_path2(main) -> dict:
    """The fused-kernel solve of the main path's instance through the
    sharded solver at world size 1 over NCCL, counted, timed and held
    against the main path's fused-oracle solve, and against the
    single-device fused-kernel solve, which it equals at world size 1."""
    import torch

    from repro_torch.core import (
        DistConfig, DistributedMaximizer, Maximizer, MatchingObjective,
    )
    from repro_torch.core.sharding import _make_calculate
    from repro_torch.launch import dist as launch_dist

    r = main["run"]
    inst, ref, cfg = r.instance, r.result, r.config
    launch_dist.setup("cuda:0", init_method=f"tcp://localhost:{free_port()}",
                      rank=0, world_size=1)
    dm = DistributedMaximizer(inst, cfg, DistConfig(fused_kernel=True))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = dm.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    value = matched_value(r, dm.gather_primal(res.x_slabs))
    allreduce_ms = allreduce_time(inst.dual_dim + 2)
    single = Maximizer(MatchingObjective(inst, fused_kernel=True), cfg).solve()
    profiled = profile_iterations(
        _make_calculate(dm.objective, dm.dist, dm.local.rhs), res.lam,
        cfg.gammas[-1], "path2")
    launch_dist.teardown()
    expect = len(inst.buckets) * (r.total_iters + 1)
    out = {
        "phase": "path2", "world_size": 1, "backend": "nccl",
        "iterations": r.total_iters, "solve_s": solve_s,
        "ms_per_iter": solve_s / r.total_iters * 1e3,
        "launch_counts": counts, "expected_launches": expect,
        "allreduce_ms": allreduce_ms,
        "g": float(res.g), "value": value,
        "rel_g_vs_main": rel_diff(res.g, ref.g),
        "rel_value_vs_main": rel_diff(value, r.value),
        "rel_lam_vs_main": rel_l2(res.lam, ref.lam),
        "rel_lam_vs_single_device": rel_l2(res.lam, single.lam),
        "lam_bitwise_equal_single_device": bool(torch.equal(res.lam, single.lam)),
    }
    emit(out)
    emit(profiled)
    if counts["dual_primal"] != expect or counts["dual_oracle"] or counts["width_routed"]:
        fail(f"path 2 launches {counts}, expected {expect} of the primal kernel")
    if not (out["rel_g_vs_main"] <= 1e-5 and out["rel_lam_vs_main"] <= 1e-4
            and out["rel_value_vs_main"] <= 1e-4):
        fail(f"path 2 against the fused-oracle solve beyond g 1e-5, lam and value 1e-4: {out}")
    if not out["rel_lam_vs_single_device"] <= 1e-6:
        fail(f"path 2 at world size 1 against the single-device solve: {out}")
    return out


def allreduce_time(numel: int, reps: int = 200) -> float:
    """Device ms of one all_reduce of the sharded solve's payload."""
    import torch
    import torch.distributed as tdist

    buf = torch.zeros(numel, device="cuda")
    return event_ms(lambda: tdist.all_reduce(buf), reps)


def phase_path3(main) -> dict:
    """The unfused solve of the main path's instance with the simplex kernel
    as its projection, against the same solve with the plain projection;
    both counted and timed as they run."""
    import torch

    from repro_torch.core import Maximizer, MatchingObjective, UnitSimplexProjection
    from repro_torch.core.maximizer import local_calculate

    r = main["run"]
    inst = r.instance
    kernel, plain = UnitSimplexProjection(use_kernel=True), UnitSimplexProjection()
    runs = {}
    for name, proj in (("kernel", kernel), ("plain", plain)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = Maximizer(MatchingObjective(inst, projection=proj), r.config).solve()
        torch.cuda.synchronize()
        runs[name] = (res, time.perf_counter() - t0, read_counts())
    (res, solve_s, counts), (plain_res, plain_s, plain_counts) = runs["kernel"], runs["plain"]
    profiled = profile_iterations(
        local_calculate(MatchingObjective(inst, projection=kernel)), res.lam,
        r.config.gammas[-1], "path3")
    expect = len(inst.buckets) * (r.total_iters + 1)
    out = {
        "phase": "path3", "iterations": r.total_iters,
        "ms_per_iter": solve_s / r.total_iters * 1e3,
        "plain_projection_ms_per_iter": plain_s / r.total_iters * 1e3,
        "launch_counts": counts, "expected_launches": expect,
        "g": float(res.g),
        "rel_g_vs_plain": rel_diff(res.g, plain_res.g),
        "rel_lam_vs_plain": rel_l2(res.lam, plain_res.lam),
        "lam_bitwise_equal_plain": bool(torch.equal(res.lam, plain_res.lam)),
    }
    emit(out)
    emit(profiled)
    if counts["simplex_proj"] != expect or counts["dual_oracle"] or counts["dual_primal"]:
        fail(f"path 3 launches {counts}, expected {expect} of the simplex kernel")
    if plain_counts["simplex_proj"]:
        fail("the plain projection launched the simplex kernel")
    if not (out["rel_g_vs_plain"] <= 1e-5 and out["rel_lam_vs_plain"] <= 1e-4):
        fail(f"path 3 against the plain projection beyond g 1e-5, lam 1e-4: {out}")
    return out


TWO_RANK_SPEC = dict(num_sources=20_000, num_destinations=1_000, avg_degree=8.0,
                     num_families=1, seed=0)
# early stopping that fires decisively: at gamma = 0.1 max(0, Ax - b) falls
# from 1.6e-2 to 4e-5 across the check where the stage stops (CPU rehearsal)
TWO_RANK_CFG = dict(gammas=(10.0, 1.0, 0.1), iters_per_stage=400,
                    adaptive_restart=False, tol_viol=1e-4, check_every=50)


def two_rank_instance():
    from repro_torch.core import normalize_rows
    from repro_torch.instances import (
        MatchingInstanceSpec, bucketize, generate_matching_instance,
    )

    edges = generate_matching_instance(MatchingInstanceSpec(**TWO_RANK_SPEC))
    return normalize_rows(bucketize(edges, shard_multiple=2, device="cpu"))[0]


def two_rank_worker(rank, world, port, out_file):
    """One of two processes of the sharded solve on cuda:0, over gloo."""
    import torch

    from repro_torch.core import DistConfig, DistributedMaximizer, MaximizerConfig
    from repro_torch.launch import dist as launch_dist

    launch_dist.setup("cuda:0", init_method=f"tcp://localhost:{port}", rank=rank,
                      world_size=world, backend="gloo")
    reset_counts()
    dm = DistributedMaximizer(two_rank_instance(), MaximizerConfig(**TWO_RANK_CFG),
                              DistConfig(comm_mode="psum", fused_kernel=True),
                              device="cuda:0")
    res = dm.solve()
    if rank == 0:
        torch.save({"lam": res.lam.cpu(), "g": float(res.g),
                    "iters_used": res.iters_used, "counts": read_counts()}, out_file)
    launch_dist.teardown()


def phase_two_ranks() -> dict:
    import torch
    import torch.multiprocessing as mp

    from repro_torch.core import Maximizer, MaximizerConfig, MatchingObjective

    one = Maximizer(
        MatchingObjective(two_rank_instance().to("cuda:0"), fused_kernel=True),
        MaximizerConfig(**TWO_RANK_CFG)).solve()
    out_file = ROOT / "build" / "chip_smoke_two_ranks.pt"
    out_file.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(two_rank_worker, args=(2, free_port(), str(out_file)), nprocs=2, join=True)
    two = torch.load(out_file, weights_only=False)
    out = {
        "phase": "two_ranks", "world_size": 2, "backend": "gloo", "device": "cuda:0",
        "spec": TWO_RANK_SPEC, "seconds": time.perf_counter() - t0,
        "iters_used_one": list(one.iters_used), "iters_used_two": list(two["iters_used"]),
        "rank0_launch_counts": two["counts"],
        "rel_lam_vs_one": rel_l2(two["lam"], one.lam),
        "rel_g_vs_one": abs(two["g"] - float(one.g)) / abs(float(one.g)),
    }
    emit(out)
    if tuple(two["iters_used"]) != tuple(one.iters_used):
        fail(f"two ranks ran {two['iters_used']} iterations, one process {one.iters_used}")
    if not out["rel_lam_vs_one"] <= 1e-5:
        fail(f"two ranks against one process: rel lam {out['rel_lam_vs_one']} > 1e-5")
    if not two["counts"]["dual_primal"] > 0:
        fail("the two-rank solve did not launch the primal kernel")
    return out


def phase_times(main) -> dict:
    import torch

    from repro_torch.core.maximizer import local_calculate
    from repro_torch.kernels import dual_oracle as kdo
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    r = main["run"]
    inst, lam = r.instance, r.result.lam
    J, m = inst.num_destinations, inst.num_families
    gamma = r.config.gammas[-1]
    slot_bytes = kops.oracle_slab_slot_bytes(m, inst.slab_dtype)
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bucket_bytes(b):  # each input read once, each output written once
        return b.idx.numel() * slot_bytes + 4 * m * J * 2  # + lam read, hist write

    def bucket_ops(b):  # fp32 operations this slot's work needs
        lg = int(math.log2(b.length))
        per_slot = 2 * m + 2 + lg * (lg + 1) // 2 * 2 + lg + 8 + 2 * m + 4
        return b.idx.numel() * per_slot

    rows = []
    main_err, main_exact = 0.0, 0
    for b in inst.buckets:
        args, kw = oracle_args(b, lam, gamma, J, True)
        # x at the main path's shapes against the plain version
        err, exact = held(kdo.dual_oracle(*args, **kw)[0],
                          kref.dual_oracle_ref(*args, J, radius=1.0, inequality=True)[0],
                          X_ATOL[inst.slab_dtype])
        main_err, main_exact = max(main_err, err), main_exact + exact
        plan = kdo.plan_launch(b.rows, b.length, m, J, num_sms)
        reps = 50 if b.idx.numel() > 100_000 else 200
        rows.append({
            "L": b.length, "rows": b.rows, "slots": b.idx.numel(),
            "grid": plan.grid, "warps": plan.warps, "lam_in_smem": plan.lam_in_smem,
            "kernel_ms": event_ms(lambda: kdo.dual_oracle(*args, **kw), reps),
            "plain_ms": event_ms(
                lambda: kref.dual_oracle_ref(*args, J, radius=1.0, inequality=True),
                max(5, reps // 10)),
            "bound_ms": max(bucket_bytes(b) / HBM_BYTES_PER_S,
                            bucket_ops(b) / FP32_FLOPS) * 1e3,
        })
    for row in rows:
        emit({"phase": "times_bucket", **row})
    largest = max(inst.buckets, key=lambda b: b.idx.numel())
    args, kw = oracle_args(largest, lam, gamma, J, True)
    first, second = kdo.dual_oracle(*args, **kw), kdo.dual_oracle(*args, **kw)
    bitwise = all(torch.equal(a, c) for a, c in zip(first, second))
    if not bitwise:
        fail("kernel outputs differ between two calls on the main path's bucket")

    def call_kernels():
        for b in inst.buckets:
            a, k = oracle_args(b, lam, gamma, J, True)
            kdo.dual_oracle(*a, **k)

    def call_fused():
        for b in inst.buckets:
            a, k = oracle_args(b, lam, gamma, J, True)
            kops.fused_dual_oracle(*a, **k)

    def call_plain():
        for b in inst.buckets:
            a, _ = oracle_args(b, lam, gamma, J, True)
            kref.dual_oracle_ref(*a, J, radius=1.0, inequality=True)

    bytes_total = sum(bucket_bytes(b) for b in inst.buckets)
    ops_total = sum(bucket_ops(b) for b in inst.buckets)
    out = {
        "phase": "times_call",
        "kernel_ms": event_ms(call_kernels, 30),
        "fused_dual_oracle_ms": event_ms(call_fused, 30),
        "plain_ms": event_ms(call_plain, 5),
        "bytes": bytes_total, "fp32_ops": ops_total,
        "bytes_bound_ms": bytes_total / HBM_BYTES_PER_S * 1e3,
        "ops_bound_ms": ops_total / FP32_FLOPS * 1e3,
        "largest_bucket": {"L": largest.length, "rows": largest.rows},
        "largest_bucket_bitwise_equal_rerun": bitwise,
        "main_path_x_max_abs_err": main_err,
        "main_path_x_bitwise_equal_buckets": main_exact,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused oracle",
    }
    out["bound_ms"] = max(out["bytes_bound_ms"], out["ops_bound_ms"])
    out["bound_by"] = "bytes" if out["bytes_bound_ms"] >= out["ops_bound_ms"] else "operations"
    emit(out)
    emit(profile_iterations(local_calculate(r.objective), r.result.lam,
                            r.config.gammas[-1], "main"))
    return out


def phase_times_primal_simplex(main) -> dict:
    """The primal-step and simplex kernels at the main path's shapes: per
    bucket and per call (all buckets), by CUDA events, against their plain
    versions and their HBM bounds.  The simplex kernel projects the unfused
    oracle's primal candidates at the main path's final duals."""
    import torch

    from repro_torch.core.objective import gather_at_lam, inv_gamma
    from repro_torch.kernels import dual_oracle as kdo
    from repro_torch.kernels import dual_primal as kdp
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import simplex_proj as ksp

    r = main["run"]
    inst, lam = r.instance, r.result.lam
    J, m = inst.num_destinations, inst.num_families
    gamma = r.config.gammas[-1]
    lg = lambda b: int(math.log2(b.length))
    sort_scan = lambda k: k * (k + 1) // 2 * 2 + k + 8  # per slot: sort, scan, cut
    # the primal kernel: idx, m + 2 slab words and the x write per slot, lam once
    slot2 = kops.oracle_slab_slot_bytes(m, inst.slab_dtype)
    bytes2 = lambda b: b.idx.numel() * slot2 + 4 * m * J
    ops2 = lambda b: b.idx.numel() * (2 * m + 2 + sort_scan(lg(b)))
    # the simplex kernel: v and mask read, out written, per slot
    bytes3 = lambda b: b.idx.numel() * 3 * b.cost.element_size()
    ops3 = lambda b: b.idx.numel() * sort_scan(lg(b))
    lam2 = lam.reshape(m, J)
    ginv = inv_gamma(gamma)
    vs = [-(gather_at_lam(b.coeff, b.idx, lam2) + b.cost) * ginv for b in inst.buckets]
    args = [oracle_args(b, lam, gamma, J, True) for b in inst.buckets]

    # each kernel at the main path's shapes against its plain version
    atol = X_ATOL[inst.slab_dtype]
    held_by = {"primal": [], "simplex": []}
    for b, v, (a, kw) in zip(inst.buckets, vs, args):
        held_by["primal"].append(held(
            kdp.dual_primal(*a, **kw),
            kref.dual_primal_ref(*a, J, radius=1.0, inequality=True), atol))
        held_by["simplex"].append(held(ksp.simplex_proj(v, b.mask),
                                       kref.simplex_ref(v, b.mask), atol))

    rows = []
    for b, v, (a, kw) in zip(inst.buckets, vs, args):
        reps = 50 if b.idx.numel() > 100_000 else 200
        rows.append({
            "L": b.length, "rows": b.rows, "slots": b.idx.numel(),
            "primal_kernel_ms": event_ms(lambda: kdp.dual_primal(*a, **kw), reps),
            "primal_plain_ms": event_ms(
                lambda: kref.dual_primal_ref(*a, J, radius=1.0, inequality=True),
                max(5, reps // 10)),
            "primal_bound_ms": max(bytes2(b) / HBM_BYTES_PER_S, ops2(b) / FP32_FLOPS) * 1e3,
            "simplex_kernel_ms": event_ms(lambda: ksp.simplex_proj(v, b.mask), reps),
            "simplex_plain_ms": event_ms(lambda: kref.simplex_ref(v, b.mask),
                                         max(5, reps // 10)),
            "simplex_bound_ms": max(bytes3(b) / HBM_BYTES_PER_S, ops3(b) / FP32_FLOPS) * 1e3,
        })
    for row in rows:
        emit({"phase": "times_bucket_primal_simplex", **row})
    largest = max(range(len(inst.buckets)), key=lambda i: inst.buckets[i].idx.numel())
    a, kw = args[largest]
    x_equal = torch.equal(kdp.dual_primal(*a, **kw), kdo.dual_oracle(*a, **kw)[0])
    if not x_equal:
        fail("primal kernel's x differs from the oracle's on the main path's largest bucket")

    def over_buckets(fn):  # one call: every bucket once
        return lambda: [fn(i) for i in range(len(inst.buckets))]

    out = {"phase": "times_call_primal_simplex", "library_ms": None,
           "library_note": "no single PyTorch call computes either function",
           "largest_bucket_x_bitwise_equal_oracle": x_equal}
    for name, bytes_fn, ops_fn in (("primal", bytes2, ops2), ("simplex", bytes3, ops3)):
        byts = sum(bytes_fn(b) for b in inst.buckets)
        ops = sum(ops_fn(b) for b in inst.buckets)
        out[name] = {"bytes": byts, "fp32_ops": ops,
                     "bytes_bound_ms": byts / HBM_BYTES_PER_S * 1e3,
                     "ops_bound_ms": ops / FP32_FLOPS * 1e3}
        out[name]["bound_ms"] = max(out[name]["bytes_bound_ms"], out[name]["ops_bound_ms"])
        out[name]["bound_by"] = ("bytes" if out[name]["bytes_bound_ms"]
                                 >= out[name]["ops_bound_ms"] else "operations")
        out[name]["main_path_max_abs_err"] = max(e for e, _ in held_by[name])
        out[name]["main_path_bitwise_equal_buckets"] = sum(x for _, x in held_by[name])
    out["primal"]["kernel_ms"] = event_ms(
        over_buckets(lambda i: kdp.dual_primal(*args[i][0], **args[i][1])), 30)
    out["primal"]["plain_ms"] = event_ms(over_buckets(
        lambda i: kref.dual_primal_ref(*args[i][0], J, radius=1.0, inequality=True)), 5)
    out["simplex"]["kernel_ms"] = event_ms(
        over_buckets(lambda i: ksp.simplex_proj(vs[i], inst.buckets[i].mask)), 30)
    out["simplex"]["plain_ms"] = event_ms(
        over_buckets(lambda i: kref.simplex_ref(vs[i], inst.buckets[i].mask)), 5)
    emit(out)
    return out


def profile_iterations(calculate, lam, gamma: float, tag: str, iters: int = 20) -> dict:
    """Device busy share of a window of AGD iterations of `calculate` at
    duals `lam`, from a torch.profiler trace: the summed time of the device's
    own events (kernels, copies, fills) over the host-clocked wall time of
    the window, each kernel of the port per iteration (one instantiation per
    bucket width: the bucket's device time, free of the host's launch
    overhead that the event timing of a small bucket measures), and the top
    device events.  Host-side ops (`aten::*`) also carry the device time of
    the kernels they launch; they are left out, or it would count twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.maximizer import _stage_scan

    eta = torch.full((), 1e-3, device=lam.device)
    step = lambda: _stage_scan(calculate, lam, gamma, eta, iters,
                               acceleration=True, adaptive_restart=True)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    busy_ms = sum(t for _, t in rows)
    rows.sort(key=lambda kv: -kv[1])
    kernels = [[m.group(0), t / iters] for k, t in rows
               if (m := re.search(r"(dual_oracle|dual_primal|simplex)_\w+<[^>]*>", k))]
    return {
        "phase": "profile", "path": tag, "iterations": iters,
        "wall_ms_per_iter": wall_ms / iters,
        "device_busy_ms_per_iter": busy_ms / iters if rows else "not measured",
        "device_idle_share": 1.0 - busy_ms / wall_ms if rows else "not measured",
        "kernel_device_ms_per_iter": kernels if rows else "not measured",
        "top_device_ms_per_iter": [[k[:60], t / iters] for k, t in rows[:8]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", type=int, default=1_000_000,
                    help="main-path sources (smaller only for quick iterations)")
    ap.add_argument("--sweeps-only", action="store_true",
                    help="build and sweep the kernels, then stop (no result line)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # 2. build
    t0 = time.perf_counter()
    secs = build.build(KERNELS)
    ptxas = {k: [ln.strip() for ln in build.build_logs.get(k, "").splitlines()
                 if "registers" in ln or "spill" in ln] for k in KERNELS}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": secs,
          "ptxas_lines": {k: len(v) for k, v in ptxas.items()},
          "ptxas_sample": {k: v[:4] for k, v in ptxas.items()}})

    # 3. sweeps
    sweep = timed(phase_sweep, device)
    sweep2 = timed(phase_sweep2, device)
    sweep3 = timed(phase_sweep3, device)
    if args.sweeps_only:
        return 0

    # 4. the paths, 5. times
    main_path = timed(phase_main_path, args.sources)
    path2 = timed(phase_path2, main_path)
    path3 = timed(phase_path3, main_path)
    timed(phase_two_ranks)
    times = timed(phase_times, main_path)
    times23 = timed(phase_times_primal_simplex, main_path)

    def worst(sw):
        return max(v if isinstance(v, float) else max(v.values())
                   for v in sw["worst_abs_err"].values())

    def entry(name, replaces, launches, err, t):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None}

    emit({"kernels": [
        entry("dual_oracle", "src/repro/kernels/dual_oracle.py:87",
              main_path["summary"]["kernel_launches"],
              max(worst(sweep), times["main_path_x_max_abs_err"]), times),
        entry("dual_primal", "src/repro/kernels/dual_primal.py:100",
              path2["launch_counts"]["dual_primal"],
              max(worst(sweep2), times23["primal"]["main_path_max_abs_err"]),
              times23["primal"]),
        entry("simplex_proj", "src/repro/kernels/simplex_proj.py:97",
              path3["launch_counts"]["simplex_proj"],
              max(worst(sweep3), times23["simplex"]["main_path_max_abs_err"]),
              times23["simplex"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
