#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py [--sources 1000000]

Phases, each printing one line before the last:
  1. device: name, count, and `nvidia-smi` name and power limit;
  2. build: the hand-written kernels from src/repro_torch/kernels/csrc;
  3. sweep: the dual-oracle kernel against its plain PyTorch version on the
     card over widths, families, slab dtypes, gammas and both simplex
     variants, padded rows and repeated idx included; then bitwise
     run-to-run equality of the kernel;
  4. main path: the one-shot fused-oracle AGD solve of
     `python -m repro_torch.launch.solve` in-process at 1M sources x 10k
     destinations, with the kernel's launch count checked against
     buckets x oracle calls, fused-vs-plain `calculate` at the final and at
     random duals, and a small solve on the card against the same on the CPU;
  5. times: the kernel, the plain version and the HBM bound at the main
     path's shapes, by CUDA events, and the device's busy share over a
     profiled window of AGD iterations (torch.profiler).
The line before the last is the JSON list of kernels; the last line is
{"ok": true, "device": {...}}.  Any failed check exits non-zero without it.
Imports torch, numpy and the port; nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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

    x_atol = {"float32": 3e-5, "bfloat16": 2e-2, "int8": 3e-5}
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


def phase_main_path(sources: int) -> dict:
    import torch

    from repro_torch.core import MatchingObjective
    from repro_torch.kernels import dual_oracle as kdo
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import solve

    args = solve.build_parser().parse_args([
        "--sources", str(sources), "--destinations", "10000",
        "--avg-degree", "8", "--families", "1", "--slab-dtype", "float32",
        "--fused-oracle", "--iters-per-stage", "100", "--device", "cuda",
    ])
    kdo.launches = 0
    kops.width_routed = 0
    r = solve.run(args)
    launches, width_routed = kdo.launches, kops.width_routed
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
        "width_routed": width_routed,
    }
    # the fused kernel against the plain unfused oracle on the card.  Near
    # the optimum grad = Ax - b is a small difference of large terms, so at
    # the final duals its rel-L2 also measures the two fp32 summation orders
    # of A x (index_add_ atomics against per-warp histograms): that one is
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

    if launches != expect:
        fail(f"kernel launches {launches} != buckets x oracle calls {expect}")
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


def phase_times(main) -> dict:
    import torch

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
    for b in inst.buckets:
        args, kw = oracle_args(b, lam, gamma, J, True)
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
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused oracle",
    }
    out["bound_ms"] = max(out["bytes_bound_ms"], out["ops_bound_ms"])
    out["bound_by"] = "bytes" if out["bytes_bound_ms"] >= out["ops_bound_ms"] else "operations"
    emit(out)
    emit(profile_iterations(r))
    return out


def profile_iterations(r, iters: int = 20) -> dict:
    """Device busy share of a window of AGD iterations at the last stage,
    from a torch.profiler trace: the sum of device self time over the
    host-clocked wall time of the window, and the top kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.maximizer import _stage_scan

    cfg, obj = r.config, r.objective
    gamma = cfg.gammas[-1]
    eta = torch.full((), 1e-3, device=r.result.lam.device)
    step = lambda: _stage_scan(obj.calculate, r.result.lam, gamma, eta, iters,
                               acceleration=True, adaptive_restart=True)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0]
    busy_ms = sum(t for _, t in rows)
    rows.sort(key=lambda kv: -kv[1])
    # one instantiation of the kernel per bucket width: its device time per
    # iteration is the bucket's, free of the host's launch overhead that the
    # event timing of a small bucket measures
    oracle = [[m.group(0), t / iters] for k, t in rows
              if (m := re.search(r"dual_oracle_\w+<[^>]*>", k))]
    return {
        "phase": "profile", "iterations": iters, "wall_ms_per_iter": wall_ms / iters,
        "device_busy_ms_per_iter": busy_ms / iters if rows else "not measured",
        "device_idle_share": 1.0 - busy_ms / wall_ms if rows else "not measured",
        "oracle_device_ms_per_iter": oracle if rows else "not measured",
        "top_device_ms_per_iter": [[k[:60], t / iters] for k, t in rows[:6]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sources", type=int, default=1_000_000,
                    help="main-path sources (smaller only for quick iterations)")
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
    secs = build.build(["dual_oracle"])
    ptxas = [ln.strip() for ln in build.build_logs.get("dual_oracle", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": secs,
          "ptxas_lines": len(ptxas), "ptxas_sample": ptxas[:4]})

    # 3-5
    sweep = phase_sweep(device)
    main_path = phase_main_path(args.sources)
    times = phase_times(main_path)

    err = max(max(v.values()) for v in sweep["worst_abs_err"].values())
    emit({"kernels": [{
        "name": "dual_oracle",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dual_oracle.cu",
        "replaces": "src/repro/kernels/dual_oracle.py:87",
        "launches": main_path["summary"]["kernel_launches"],
        "max_abs_err": err,
        "ms": times["kernel_ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
