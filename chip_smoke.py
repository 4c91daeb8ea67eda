#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py [--sources 1000000]

Phases, each printing one line before the last:
  1. device: name, count, and `nvidia-smi` name and power limit;
  2. build: the three hand-written kernels from src/repro_torch/kernels/csrc,
     one nvcc each, all started together; kernel_info: each kernel's
     registers and spills (ptxas, and the runtime's attributes), its
     resident blocks per SM at the main path's shapes, and whether the
     oracle's 64-bit shared-memory add is a native instruction (SASS);
  3. sweep: the dual-oracle kernel against its plain PyTorch version on the
     card over widths, families, slab dtypes, gammas and both simplex
     variants, padded rows and repeated idx included, with A x held bitwise
     equal to the fixed-point plain sum and within atol 3e-5 + rtol 1e-5 of
     the fp32 plain sum, on both sides of the shared-memory capacity
     boundary, and over whole calls of several buckets; then bitwise
     equality of two calls and of three grid sizes;
     sweep2 / sweep3: the primal-step and simplex kernels the same way over
     every power-of-two width up to 8192, two radii included, with the
     primal kernel's x held bitwise equal to the oracle's, and the primal
     kernel also at m*J past shared memory (lam read through L1/L2); the
     simplex kernel's x bitwise its plain version's in every case, whole
     calls of nine widths in one plan and three grid sizes included;
  4. main path: the one-shot fused-oracle AGD solve of
     `python -m repro_torch.launch.solve` in-process at 1M sources x 10k
     destinations, with the kernel's launch count checked against the
     oracle calls (one oracle launch and one finalize each), fused-vs-plain
     `calculate` at the final and at
     random duals, and a small solve on the card against the same on the CPU;
     path2: the same instance solved by `DistributedMaximizer` (world size
     1 over NCCL) with the fused primal kernel, against the main path and
     the single-device solve;
     path3: the same instance solved with the simplex kernel as the unfused
     oracle's projection (one launch per oracle call), against the same
     solve with the plain projection;
     two_ranks: a small sharded solve in two processes sharing the card
     over gloo, against one process;
     pdhg_path: the fused PDHG solve of the main path's size through
     `python -m repro_torch.launch.solve --engine pdhg --fused-oracle`
     (600 iterations, adaptive restart, checks every 50), one oracle launch
     and one finalize per iteration, against the unfused PDHG solve on the
     card (primal objectives within rtol 1e-3), and a profiled window;
     pdhg_step: one whole-call fused PDHG prox step at the main path's
     instance, x+ bitwise the plain whole call on the same cost_eff, A x+
     bitwise the fixed-point plain sum, cost_eff bitwise the CPU's, timed;
     formulation_path: the capacity-cap formulation at the main path's
     instance through the AGD engine and the unfused oracle (no kernel);
  5. times: each kernel's output at the main path's shapes held against
     its plain version; each kernel, its plain version and its HBM bound
     there, per bucket and per whole call, by CUDA events (the simplex
     kernel also by profiler device time, at fp32 and bf16, and with L2
     flushed before each call); the all-reduce of the sharded solve at
     world size 1; and the device's busy share over a profiled window of
     AGD iterations (torch.profiler);
  6. cadence_path: the recurring-solve cadence at the main path's instance
     (`DeltaIngestor`, `device_put_instance`, three cadences of
     `compiled_solver` with the fused oracle: cold, a mixed delta replayed
     by `apply_scatter_plan` and solved warm, a cost-only delta solved with
     `compiled_solver_fixed_sigma`), each replay bitwise a fresh upload,
     kernel 1 in every AGD iteration, the warm solve against the unfused
     one, drift against the gamma bound, convergence traces and the
     Prometheus text; coo_pdhg: the unstructured COO PDHG baseline at the
     main path's instance (600 iterations, two runs bit-equal) and at
     tests/test_pdhg.py's size against scipy's HiGHS.
Every path is driven with all launch counters set to 0 just before it and
read just after; kernel 1's entry in the kernels line gives its launches on
each path it runs (`launches_by_path`).  The line before the last is the JSON list of kernels; the
last line is {"ok": true, "device": {...}}.  Any failed check exits
non-zero without it.  Imports torch, numpy and the port; nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
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


def host_ms(fn, reps: int = 200) -> float:
    """Mean host time to enqueue one call of `fn` (no synchronisation inside
    the window): the host's share of a call that the device runs behind."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def reset_counts() -> None:
    """Every kernel's launch counter and the width rule's to 0."""
    from repro_torch.kernels import dual_oracle, dual_primal, ops, simplex_proj

    dual_oracle.launches = dual_oracle.finalize_launches = 0
    dual_primal.launches = simplex_proj.launches = 0
    ops.width_routed = 0


def read_counts() -> dict:
    from repro_torch.kernels import dual_oracle, dual_primal, ops, simplex_proj

    return {"dual_oracle": dual_oracle.launches,
            "dual_oracle_finalize": dual_oracle.finalize_launches,
            "dual_primal": dual_primal.launches,
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


def ptxas_summary(logs: dict) -> dict:
    """Registers, spill stores and stack frame bytes (local memory) of every
    kernel entry, from the build's `nvcc -Xptxas -v` output, by demangled
    name (a library built by an earlier process of the same checkout has no
    output here)."""
    out = {k: "not built in this process" for k in KERNELS}
    for kernel, log in logs.items():
        rows, name = {}, None
        for ln in log.splitlines():
            if mm := re.search(r"Compiling entry function '([^']+)'", ln):
                name = mm.group(1)
                rows[name] = [None, None, None]
            elif name and (mm := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                                           ln)):
                rows[name][1:] = [int(mm.group(2)), int(mm.group(1))]
            elif name and (mm := re.search(r"Used (\d+) registers", ln)):
                rows[name][0] = int(mm.group(1))
        try:
            names = subprocess.run(["c++filt"], input="\n".join(rows), capture_output=True,
                                   text=True, timeout=60).stdout.splitlines()
        except OSError:
            names = list(rows)
        short = [re.sub(r"\(anonymous namespace\)::|\(.*\)$|^void ", "", n) for n in names]
        out[kernel] = dict(zip(short, rows.values())) if len(short) == len(rows) else rows
    return out


def phase_kernel_info(ptxas: dict) -> dict:
    """Registers, spills and resident blocks per SM of the oracle's and the
    primal step's instantiations (the runtime's attributes, at the main
    path's m*J = 10k layout) and of the simplex kernel's, ptxas's registers
    and spill stores of every kernel entry, and the SASS opcode of the
    oracle's shared int64 add."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import dual_oracle as kdo
    from repro_torch.kernels import simplex_proj as ksp

    runtime = {}
    for kernel, layout in (("dual_oracle", kdo.oracle_layout), ("dual_primal", kdo.primal_layout)):
        for M in (1, 2, 4, 8):
            for L in (8, 8192):
                lay = layout(L, M, 10_000)
                info = kdo.kernel_info(kernel, torch.float32, M, L > 32, 32 * lay.warps,
                                       lay.smem_bytes)
                runtime[f"{kernel} {'wide' if L > 32 else 'narrow'} fp32 M={M}"] = {
                    "threads": 32 * lay.warps, "smem_bytes": lay.smem_bytes, **info}
    card = torch.device("cuda", 0)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        threads = 32 * ksp.MAX_WARPS
        smem = ksp.MAX_WARPS * ksp.stage_bytes(ksp.REGISTER_MAX_WIDTH, dtype)
        runtime[f"simplex_proj narrow {name}"] = {
            "threads": threads, "smem_bytes": smem,
            **ksp.kernel_info(card, dtype, False, threads, smem)}
        warps = ksp.wide_warps(8192)
        runtime[f"simplex_proj wide {name} L=8192"] = {
            "threads": 32 * warps, "smem_bytes": 8 * warps * 8192,
            **ksp.kernel_info(card, dtype, True, 32 * warps, 8 * warps * 8192)}
    sass = subprocess.run(
        [str(Path(build._nvcc()).parent / "cuobjdump"), "-sass",
         str(build._library("dual_oracle"))], capture_output=True, text=True, timeout=300,
    ).stdout
    shared = sorted({mm.group(0) for mm in re.finditer(r"ATOMS\.[A-Z0-9.]+", sass)})
    out = {"phase": "kernel_info", "runtime_at_mJ_10000": runtime, "ptxas": ptxas,
           "shared_int64_add_sass": shared,
           "shared_int64_add_native": any(op.startswith("ATOMS.ADD") and "64" in op
                                          for op in shared)}
    emit(out)
    return out


def phase_sweep(device) -> dict:
    """The oracle kernel against its plain version: one call per case of one
    bucket or of several (one narrow launch, one wide per bucket wider than
    32, one finalize), x within X_ATOL (and counted where bitwise), A x
    bitwise the fixed-point plain sum and within atol 3e-5 + rtol 1e-5 of
    the fp32 plain sum, c'x and ||x||^2 within the same."""
    import numpy as np
    import torch

    from repro_torch.kernels import dual_oracle as kdo
    from repro_torch.kernels import ref as kref

    worst = {d: {"x": 0.0, "partials": 0.0} for d in X_ATOL}
    counts = {"cases": 0, "x_exact": 0, "ax_fixed_point_exact": 0}
    bad = []
    rng = np.random.default_rng(0)

    def check(buckets, lam, J, dtype, gamma, inequality, tag):
        plan = kdo.plan_slabs("dual_oracle", buckets, J, inequality=inequality)
        xs, ax, lin, sq = kdo.oracle_call(plan, lam, gamma)
        want = kref.dual_oracle_call_ref(buckets, lam, gamma, J, inequality=inequality)
        fixed = kref.fixed_point_hist(buckets, lam, gamma, J, plan.shift,
                                      inequality=inequality)
        torch.cuda.synchronize()
        tag = f"{tag} {dtype} gamma={gamma} ineq={inequality}"
        exact = True
        for x, w in zip(xs, want[0]):
            ex = float((x.float() - w.float()).abs().max()) if x.numel() else 0.0
            if x.dtype != w.dtype or not ex <= X_ATOL[dtype]:
                bad.append(f"x {x.dtype} max error {ex} ({tag})")
            if x.numel() and float(x[:5].float().abs().max()) != 0.0:
                bad.append(f"padded rows not exactly zero ({tag})")
            worst[dtype]["x"] = max(worst[dtype]["x"], ex)
            exact &= bool(torch.equal(x, w))
        for a, w, name in zip((ax, lin, sq), want[1:], ("ax", "lin", "sq")):
            err = (a - w).abs()
            if not bool((err <= 3e-5 + 1e-5 * w.abs()).all()):
                bad.append(f"{name} max error {float(err.max())} ({tag})")
            worst[dtype]["partials"] = max(worst[dtype]["partials"], float(err.max()))
        fixed_exact = bool(torch.equal(ax, fixed))
        if not fixed_exact:
            bad.append(f"A x not bitwise the fixed-point sum: "
                       f"{float((ax - fixed).abs().max())} ({tag})")
        counts["cases"] += 1
        counts["x_exact"] += int(exact)
        counts["ax_fixed_point_exact"] += int(fixed_exact)
        return plan

    def bucket(n, L, m, J, dtype):
        return random_bucket(rng, n, L, m, J, dtype, device, 5)

    # one bucket a call: every width class, m = 1 and 3, lam staged or not
    shapes = [(L, 1000 if L <= 64 else (37 if L <= 512 else 9), 64)
              for L in (1, 4, 8, 16, 32, 64, 512, 8192)]
    shapes += [(8, 20000, 10000), (16, 3000, 40000)]
    for L, n, J in shapes:
        for m in ((1, 3) if J == 64 else (1,)):
            for dtype in X_ATOL:
                b, lam = bucket(n, L, m, J, dtype)
                for gamma in (0.01, 1.0, 100.0):
                    for inequality in (True, False):
                        check([b], lam, J, dtype, gamma, inequality, f"L={L} n={n} J={J} m={m}")
    # both sides of the shared-memory histogram's capacity, and the largest
    # m*J the previous design took (narrow 56,000, wide 41,000 at L = 8192)
    boundary = []
    for L, n, J in ((8, 2000, 29_000), (8, 2000, 29_100), (8, 2000, 56_000),
                    (8192, 9, 20_000), (8192, 9, 21_000), (8192, 9, 41_000)):
        for dtype in X_ATOL:
            b, lam = bucket(n, L, 1, J, dtype)
            for gamma, inequality in ((0.01, True), (1.0, False)):
                plan = check([b], lam, J, dtype, gamma, inequality, f"L={L} n={n} J={J} m=1")
        lay = plan.launches[0].layout
        boundary.append({"L": L, "J": J, "hist": ["smem", "global"][lay.hist_mode],
                         "lam_in_smem": lay.lam_in_smem, "warps": lay.warps,
                         "smem_bytes": lay.smem_bytes})
    sides = {(row["L"] > 32, row["hist"]) for row in boundary}
    if sides != {(False, "smem"), (False, "global"), (True, "smem"), (True, "global")}:
        fail(f"capacity sweep missed a side of the boundary: {boundary}")
    # whole calls: widths 1-32 in one launch, 64 in a second, m = 1, 2, 3
    for m in (1, 2, 3):
        for dtype in X_ATOL:
            J = 64
            buckets = [bucket(300 + 17 * L, L, m, J, dtype)[0] for L in (1, 2, 4, 8, 16, 32, 64)]
            lam = torch.from_numpy(rng.random(m * J).astype(np.float32)).to(device)
            for gamma in (0.01, 1.0, 100.0):
                for inequality in (True, False):
                    check(buckets, lam, J, dtype, gamma, inequality, f"whole call m={m}")
    if bad:
        fail(f"{len(bad)} of {counts['cases']} sweep cases out of tolerance: {bad[:8]}")
    # the same input twice, and under two other grids: bitwise the same
    J = 10_000
    buckets = [bucket(n, L, 1, J, "float32")[0] for L, n in ((4, 3000), (8, 40_000), (16, 30_000))]
    lam = torch.from_numpy(rng.random(J).astype(np.float32)).to(device)
    plans = [kdo.plan_slabs("dual_oracle", buckets, J, grid=g) for g in (None, 7, 1)]
    first, second = kdo.oracle_call(plans[0], lam, 0.5), kdo.oracle_call(plans[0], lam, 0.5)
    rerun = (all(torch.equal(a, c) for a, c in zip(first[0], second[0]))
             and all(torch.equal(a, c) for a, c in zip(first[1:], second[1:])))
    grids = [kdo.oracle_call(p, lam, 0.5) for p in plans[1:]]
    across = all(torch.equal(g[1], first[1]) and all(torch.equal(a, c) for a, c in
                                                    zip(g[0], first[0])) for g in grids)
    out = {"phase": "sweep", "cases": counts["cases"],
           "x_bitwise_equal_cases": counts["x_exact"],
           "ax_bitwise_fixed_point_cases": counts["ax_fixed_point_exact"],
           "worst_abs_err": worst, "capacity_boundary": boundary,
           "bitwise_equal_rerun": rerun,
           "grids": [p.launches[0].grid for p in plans],
           "ax_bitwise_equal_across_grids": across}
    emit(out)
    if not rerun:
        fail("kernel outputs differ between two calls on one input")
    if not across:
        fail("A x or x differ between grid sizes")
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
        if kdo.primal_layout(L, m, J).lam_in_smem:
            fail(f"primal kernel plans lam in shared memory at L={L} m={m} J={J}")
        check(L, n, m, J, False)
    # whole calls: every width up to 32 in one launch, 64 and 512 one each;
    # x bitwise the oracle's whole call
    whole = whole_cases = 0
    for m in (1, 2, 3):
        for dtype in X_ATOL:
            buckets = [random_bucket(rng, 200 + 13 * L if L <= 64 else 20, L, m, 64, dtype,
                                     device, 5)[0] for L in (1, 2, 4, 8, 16, 32, 64, 512)]
            lam = torch.from_numpy(rng.random(m * 64).astype(np.float32)).to(device)
            primal = kdo.plan_slabs("dual_primal", buckets, 64)
            oracle = kdo.plan_slabs("dual_oracle", buckets, 64)
            if len(primal.launches) != 3:
                fail(f"primal whole call of 8 buckets in {len(primal.launches)} launches")
            for gamma in (0.01, 1.0):
                xs = kdp.primal_call(primal, lam, gamma)
                oxs = kdo.oracle_call(oracle, lam, gamma)[0]
                whole += int(all(torch.equal(a, c) for a, c in zip(xs, oxs)))
                whole_cases += 1
    cases, oracle_cases = counts["cases"], counts["cases"] - counts["lam_in_l2"]
    out = {"phase": "sweep2", "cases": cases, "lam_in_l2_cases": counts["lam_in_l2"],
           "worst_abs_err": worst,
           "x_bitwise_equal_plain_cases": counts["exact_plain"],
           "x_bitwise_equal_oracle_cases": counts["exact_oracle"],
           "oracle_cases": oracle_cases,
           "whole_call_cases": whole_cases, "whole_call_x_bitwise_equal_oracle": whole}
    emit(out)
    if whole != whole_cases:
        fail(f"primal whole call's x bitwise the oracle's in {whole} of {whole_cases} cases")
    if bad:
        fail(f"{len(bad)} of {cases} primal-kernel sweep cases out of tolerance: {bad[:8]}")
    if counts["exact_oracle"] != oracle_cases:
        fail(f"primal kernel's x bitwise equal to the oracle's in "
             f"{counts['exact_oracle']} of {oracle_cases} cases")
    return out


def phase_sweep3(device) -> dict:
    """The simplex kernel against its plain version: one slab a call over
    every width, then whole calls of nine slabs of widths 1 to 8192 in one
    plan (one narrow launch, three wide), then one plan under three grid
    sizes; x bitwise the plain version's in every case."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import simplex_proj as ksp

    worst = {"float32": 0.0, "bfloat16": 0.0}
    counts = {"cases": 0, "exact": 0, "whole_cases": 0, "whole_exact": 0}
    bad = []
    rng = np.random.default_rng(2)

    def candidates(n, L):
        v32 = torch.from_numpy((rng.normal(size=(n, L)) * 2).astype(np.float32))
        mask32 = torch.from_numpy((rng.random((n, L)) < 0.7).astype(np.float32))
        mask32[:5] = 0.0
        return v32, mask32

    def check(got, v, mask, radius, inequality, tag, key):
        want = kref.simplex_ref(v, mask, radius, inequality=inequality)
        torch.cuda.synchronize()
        dtype = str(v.dtype).removeprefix("torch.")
        tag = f"{tag} {dtype} r={radius} ineq={inequality}"
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        if got.dtype != v.dtype or not err <= X_ATOL[dtype]:
            bad.append(f"{got.dtype} max error {err} ({tag})")
        if got.numel() and float(got[:5].float().abs().max()) != 0.0:
            bad.append(f"padded rows not exactly zero ({tag})")
        exact = bool(torch.equal(got, want))
        if not exact:
            bad.append(f"not bitwise the plain version ({tag})")
        worst[dtype] = max(worst[dtype], err)
        counts[key] += 1
        counts[key.replace("cases", "exact")] += int(exact)

    for L in (1 << k for k in range(14)):
        v32, mask32 = candidates(sweep_rows(L), L)
        for dtype in worst:
            dt = getattr(torch, dtype)
            v, mask = v32.to(device, dt), mask32.to(device, dt)
            for radius in (1.0, 2.5):
                for inequality in (True, False):
                    got = ksp.simplex_proj(v, mask, radius, inequality=inequality)
                    check(got, v, mask, radius, inequality, f"L={L}", "cases")
    widths = (1, 2, 4, 8, 16, 32, 64, 512, 8192)
    slabs = [candidates(3000 if L <= 32 else sweep_rows(L), L) for L in widths]
    shapes = [tuple(v.shape) for v, _ in slabs]
    for dtype in worst:
        dt = getattr(torch, dtype)
        vs = [v.to(device, dt) for v, _ in slabs]
        masks = [m.to(device, dt) for _, m in slabs]
        for radius in (1.0, 2.5):
            for inequality in (True, False):
                plan = ksp.plan_simplex(shapes, dt, device, radius=radius, inequality=inequality)
                if [p.wide for p in plan.launches] != [False, True, True, True]:
                    fail(f"simplex whole call of {widths} in {len(plan.launches)} launches")
                outs = ksp.simplex_call(plan, vs, masks)
                for got, v, mask, L in zip(outs, vs, masks, widths):
                    check(got, v, mask, radius, inequality, f"whole call L={L}", "whole_cases")
    vs = [v.to(device) for v, _ in slabs]
    masks = [m.to(device) for _, m in slabs]
    plans = [ksp.plan_simplex(shapes, torch.float32, device, grid=g) for g in (None, 7, 1)]
    outs = [ksp.simplex_call(p, vs, masks) for p in plans]
    across = all(torch.equal(a, b) for out in outs[1:] for a, b in zip(out, outs[0]))
    out = {"phase": "sweep3", "cases": counts["cases"], "worst_abs_err": worst,
           "bitwise_equal_plain_cases": counts["exact"],
           "whole_call_cases": counts["whole_cases"],
           "whole_call_bitwise_equal_plain_cases": counts["whole_exact"],
           "register_max_width": ksp.REGISTER_MAX_WIDTH,
           "grids": [p.launches[0].grid for p in plans], "bitwise_equal_across_grids": across}
    emit(out)
    if bad:
        fail(f"{len(bad)} simplex-kernel sweep cases out of tolerance or not bitwise: {bad[:8]}")
    if not across:
        fail("simplex kernel's x differs between grid sizes")
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
    plan = r.objective.kernel_plan("dual_oracle")
    expect = len(plan.launches) * calls  # one launch a call: every bucket has L <= 32
    out = {
        "phase": "main_path", "sources": sources, "nnz": r.edges.nnz,
        "slots": sum(b.idx.numel() for b in inst.buckets),
        "buckets": [[b.length, b.rows] for b in inst.buckets],
        "iterations": r.total_iters, "setup_s": r.setup_s, "solve_s": r.solve_s,
        "ms_per_iter": r.solve_s / r.total_iters * 1e3,
        "g": float(res.g), "value": r.value, "max_violation": r.violation,
        "sigma_sq": float(res.sigma_sq),
        "kernel_launches": launches, "expected_launches": expect, "oracle_calls": calls,
        "launches_per_call": len(plan.launches), "fixed_point_shift": plan.shift,
        "narrow_launch": launch_summary(plan.launches[0]),
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

    if (launches != expect or expect != calls or counts["dual_oracle_finalize"] != calls
            or counts["dual_primal"] or counts["simplex_proj"]):
        fail(f"kernel launches {counts}: expected {calls} oracle launches and finalizes, "
             f"one each per oracle call")
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


def launch_summary(lp) -> dict:
    """What one planned launch runs with."""
    return {"wide": lp.wide, "slabs": len(lp.slabs), "grid": lp.grid, "threads": lp.threads,
            "smem_bytes": lp.layout.smem_bytes, "lam_in_smem": lp.layout.lam_in_smem,
            "hist": ["smem", "global"][lp.layout.hist_mode],
            "blocks_per_sm": lp.blocks_per_sm, "registers": lp.registers,
            "spill_bytes": lp.spill_bytes}


def simplex_launch_summary(lp) -> dict:
    """What one planned simplex launch runs with."""
    return {"wide": lp.wide, "slabs": len(lp.slabs), "grid": lp.grid, "threads": lp.threads,
            "smem_bytes": lp.smem_bytes, "stage_bytes": lp.stage_bytes, "tasks": lp.tasks,
            "blocks_per_sm": lp.blocks_per_sm,
            "registers": lp.registers, "spill_bytes": lp.spill_bytes}


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
    from repro_torch.core.sharding import _make_calculate, gather_rows
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
    value = matched_value(r, gather_rows(res.x_slabs))
    allreduce_ms = allreduce_time(inst.dual_dim + 2)
    single = Maximizer(MatchingObjective(inst, fused_kernel=True), cfg).solve()
    profiled = profile_iterations(
        _make_calculate(dm.objective, dm.dist, dm.local.rhs), res.lam,
        cfg.gammas[-1], "path2")
    launch_dist.teardown()
    calls = r.total_iters + 1
    expect = len(dm.objective.kernel_plan("dual_primal").launches) * calls
    out = {
        "phase": "path2", "world_size": 1, "backend": "nccl",
        "iterations": r.total_iters, "solve_s": solve_s,
        "ms_per_iter": solve_s / r.total_iters * 1e3,
        "launch_counts": counts, "expected_launches": expect, "primal_calls": calls,
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
    if (counts["dual_primal"] != expect or expect != calls or counts["dual_oracle"]
            or counts["dual_oracle_finalize"] or counts["width_routed"]):
        fail(f"path 2 launches {counts}, expected {calls} of the primal kernel, one a call")
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
        obj = MatchingObjective(inst, projection=proj)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = Maximizer(obj, r.config).solve()
        torch.cuda.synchronize()
        runs[name] = (res, time.perf_counter() - t0, read_counts(), obj)
    (res, solve_s, counts, obj), (plain_res, plain_s, plain_counts, _) = (runs["kernel"],
                                                                          runs["plain"])
    profiled = profile_iterations(local_calculate(obj), res.lam, r.config.gammas[-1], "path3")
    plan = obj.kernel_plan("simplex_proj")
    calls = r.total_iters + 1
    expect = len(plan.launches) * calls  # one launch a call: every bucket has L <= 32
    out = {
        "phase": "path3", "iterations": r.total_iters,
        "ms_per_iter": solve_s / r.total_iters * 1e3,
        "plain_projection_ms_per_iter": plain_s / r.total_iters * 1e3,
        "launch_counts": counts, "expected_launches": expect, "oracle_calls": calls,
        "simplex_launch": simplex_launch_summary(plan.launches[0]),
        "g": float(res.g),
        "rel_g_vs_plain": rel_diff(res.g, plain_res.g),
        "rel_lam_vs_plain": rel_l2(res.lam, plain_res.lam),
        "lam_bitwise_equal_plain": bool(torch.equal(res.lam, plain_res.lam)),
    }
    emit(out)
    emit(profiled)
    if (counts["simplex_proj"] != expect or expect != calls or counts["dual_oracle"]
            or counts["dual_primal"] or counts["dual_oracle_finalize"]
            or counts["width_routed"]):
        fail(f"path 3 launches {counts}, expected {calls} of the simplex kernel, one a call")
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


PDHG_ARGS = ["--engine", "pdhg", "--iters-per-stage", "100"]


def phase_pdhg_path(sources: int) -> dict:
    """The fused PDHG solve through the CLI at the main path's size (the
    CLI's own check cadence, MaximizerConfig's 25): counted (one oracle
    launch and one finalize per iteration), its residuals, and against the
    unfused PDHG solve of the same instance on the card over the same
    budget; then the solve taken apart and timed piece by piece
    (`pdhg_time_split`), a profiled window of 20 fused iterations and one of
    a whole check (its iterations and its residuals)."""
    import torch

    from repro_torch.core import DistConfig, MatchingObjective
    from repro_torch.engines.pdhg import PDHGCore, PDHGEngineConfig, solve_pdhg_sharded
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import solve

    args = solve.build_parser().parse_args([
        "--sources", str(sources), "--destinations", "10000", "--avg-degree", "8",
        "--families", "1", "--slab-dtype", "float32", "--fused-oracle", "--device", "cuda",
        *PDHG_ARGS])
    reset_counts()
    r = solve.run(args)
    counts = read_counts()
    inst, res, cfg = r.instance, r.result, r.config
    obj = MatchingObjective(inst)
    step = kops.plan_pdhg_step(obj._buckets, [b.cost for b in inst.buckets],
                               num_destinations=inst.num_destinations)
    iters = r.total_iters
    expect = step.launches_per_call * iters

    def residuals(result):
        core = PDHGCore(obj, result.lam, cfg, PDHGEngineConfig(), fused_oracle=False,
                        sigma_sq=result.sigma_sq)
        x = tuple(result.x_slabs)
        pobj, dobj, pr, dr, gap = core.residuals(x, result.lam, obj.apply_A(x))
        return {"primal_obj": float(pobj), "dual_obj": float(dobj), "rel_primal": float(pr),
                "rel_dual": float(dr), "rel_gap": float(gap)}

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    unfused = solve_pdhg_sharded(inst, cfg, DistConfig(fused_oracle=False))
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    unfused_counts = read_counts()
    fused_res, unfused_res = residuals(res), residuals(unfused)
    out = {
        "phase": "pdhg_path", "sources": sources, "nnz": r.edges.nnz,
        "iterations": iters, "check_every": cfg.check_every, "restart": "adaptive",
        "setup_s": r.setup_s, "solve_s": r.solve_s, "ms_per_iter": r.solve_s / iters * 1e3,
        "restarts": res.restarts, "tau": res.steps[0], "sigma_sq": float(res.sigma_sq),
        "final": fused_res, "value": r.value,
        "launch_counts": counts, "expected_oracle_launches": expect,
        "launches_per_iteration": step.launches_per_call,
        "fixed_point_shift": step.plan.shift,
        "unfused": {"ms_per_iter": unfused_s / unfused.iters_used[0] * 1e3,
                    "iterations": unfused.iters_used[0], "restarts": unfused.restarts,
                    "final": unfused_res, "launch_counts": unfused_counts},
        "rel_l2_y_fused_vs_unfused": rel_l2(res.lam, unfused.lam),
        "rel_primal_obj_fused_vs_unfused": rel_diff(fused_res["primal_obj"],
                                                    unfused_res["primal_obj"]),
    }
    emit(out)
    core = PDHGCore(obj, res.lam, cfg, PDHGEngineConfig(), fused_oracle=True,
                    sigma_sq=res.sigma_sq)
    state = core.initial_state()

    def window():
        s = state
        for _ in range(20):
            s = core.one_iter(s)
        return s

    emit(profile_window(window, "pdhg", 20))
    split = pdhg_time_split(inst, cfg, r.solve_s)
    emit(split)
    if split["iterations"] != iters:
        fail(f"the timed split ran {split['iterations']} iterations, the CLI {iters}")
    if (counts["dual_oracle"] != expect or counts["dual_oracle_finalize"] != iters
            or counts["dual_primal"] or counts["simplex_proj"] or counts["width_routed"]):
        fail(f"pdhg path launches {counts}: expected {expect} oracle launches and {iters} "
             f"finalizes, one each per iteration")
    if any(unfused_counts.values()):
        fail(f"the unfused PDHG solve launched a kernel: {unfused_counts}")
    if iters != 600 or unfused.iters_used[0] != 600:
        fail(f"pdhg path ran {iters} and {unfused.iters_used[0]} iterations, not 600")
    finite = [*fused_res.values(), *unfused_res.values(), r.value, float(res.g)]
    if not all(math.isfinite(v) for v in finite):
        fail(f"non-finite pdhg result {out}")
    if not out["rel_primal_obj_fused_vs_unfused"] <= 1e-3:
        fail(f"fused vs unfused PDHG primal objectives beyond rtol 1e-3: {out}")
    return {"run": r, "step": step, "summary": out, "split": split}


def pdhg_time_split(inst, cfg, cli_solve_s: float) -> dict:
    """The CLI's fused PDHG solve (`solve_pdhg_sharded` at world size 1)
    taken apart, each piece timed alone by the host clock between device
    syncs: the shard copy, the power iteration, the engine's set-up
    (`PDHGCore`: the cost_eff buffers, the oracle plan over them, tau and
    sigma read once), the initial candidate, the iterations alone
    (`one_iter`, no residuals) and the same iterations with their checks
    (`_check`, as `run` drives them; no stop vote, as the CLI sets no
    tolerance).  The checks' cost is the difference of the last two.  Each
    loop is run twice, in turns, and the lesser time kept; then one
    profiled window over a whole check, and the whole solve once more
    checking every 50 iterations (called directly: not the CLI's path)."""
    import torch

    from repro_torch.core import DistConfig, MatchingObjective
    from repro_torch.core.projections import UnitSimplexProjection
    from repro_torch.core.sharding import shard_instance
    from repro_torch.engines.pdhg import PDHGCore, PDHGEngineConfig, solve_pdhg_sharded

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = fn()
        torch.cuda.synchronize()
        return v, (time.perf_counter() - t0) * 1e3

    local, shard_ms = clock(lambda: shard_instance(inst, 0, 1))
    obj = MatchingObjective(local, projection=UnitSimplexProjection(), include_rhs=False)
    sigma_sq, power_ms = clock(lambda: obj.power_iteration(cfg.seed, iters=cfg.power_iters))
    lam0 = torch.zeros(inst.dual_dim, dtype=torch.float32, device=local.device)
    core, core_ms = clock(lambda: PDHGCore(obj, lam0, cfg, PDHGEngineConfig(),
                                           fused_oracle=True, sigma_sq=sigma_sq))
    state, init_ms = clock(core.initial_state)
    total = int(cfg.total_iter_budget)
    n_checks = -(-total // core.inner)

    def steps():
        s = state
        for _ in range(n_checks * core.inner):
            s = core.one_iter(s)
        return s

    def checks():
        s = state
        for _ in range(n_checks):
            s, _ = core._check(s)
        return s

    steps_ms, loop_ms = [], []
    for _ in range(2):
        steps_ms.append(clock(steps)[1])
        loop_ms.append(clock(checks)[1])
    step_ms, whole_ms = min(steps_ms), min(loop_ms)
    check_ms = whole_ms - step_ms
    setup_ms = shard_ms + power_ms + core_ms + init_ms
    parts = setup_ms + whole_ms
    window = profile_window(lambda: core._check(state), "pdhg_check", core.inner)
    # the same solve checking every 50 iterations, the reference's test
    # cadence: not the CLI's path (its CLI fixes MaximizerConfig's 25)
    cfg50 = dataclasses.replace(cfg, check_every=50)
    res50, ms50 = clock(lambda: solve_pdhg_sharded(inst, cfg50, DistConfig(fused_oracle=True)))
    return {
        "phase": "pdhg_split", "iterations": n_checks * core.inner, "checks": n_checks,
        "check_every": core.inner, "shard_ms": shard_ms, "power_iteration_ms": power_ms,
        "core_setup_ms": core_ms, "initial_state_ms": init_ms, "setup_ms": setup_ms,
        "steps_ms_readings": steps_ms, "steps_and_checks_ms_readings": loop_ms,
        "steps_ms_per_iter": step_ms / (n_checks * core.inner),
        "checks_ms": check_ms, "ms_per_check": check_ms / n_checks,
        "parts_ms": parts, "cli_solve_ms": cli_solve_s * 1e3,
        "share_of_parts": {"setup": setup_ms / parts, "steps": step_ms / parts,
                           "checks": check_ms / parts},
        "check_window": window,
        "not_cli_check_every_50": {"ms_per_iter": ms50 / res50.iters_used[0],
                                   "iterations": res50.iters_used[0],
                                   "restarts": res50.restarts},
    }


def phase_pdhg_step(pdhg) -> dict:
    """One whole-call fused PDHG prox step at the main path's instance, from
    the PDHG solve's final x and random y: x+, A x+ and cost_eff held
    bitwise; the step's and the cost_eff write's device times by the
    profiler, its launches per step, its plain version by CUDA events."""
    import numpy as np
    import torch

    from repro_torch.kernels import dual_oracle as kdo
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    r, step = pdhg["run"], pdhg["step"]
    inst = r.instance
    J, m = inst.num_destinations, inst.num_families
    xs = tuple(r.result.x_slabs)
    gen = torch.Generator(device="cpu").manual_seed(1)
    y = torch.rand(inst.dual_dim, generator=gen).to(xs[0].device)
    tau = r.result.steps[0]
    inv_tau = float(np.float32(1.0) / np.float32(tau))
    before = (kdo.launches, kdo.finalize_launches)
    got_xs, got_ax = kops.fused_pdhg_step_call(step, xs, y, tau)
    per_step = (kdo.launches - before[0], kdo.finalize_launches - before[1])
    torch.cuda.synchronize()
    cost_eff_equal = sum(bool(torch.equal(s.cost.cpu(), torch.sub(c.cpu(), torch.mul(
        x.cpu(), inv_tau)))) for c, x, s in zip(step.costs, xs, step.slabs))
    want_xs, want_ax, _, _ = kref.dual_oracle_call_ref(step.slabs, y, inv_tau, J)
    x_held = [held(a, w, X_ATOL["float32"]) for a, w in zip(got_xs, want_xs)]
    fixed = kref.fixed_point_hist(step.slabs, y, inv_tau, J, step.plan.shift)
    ax_exact = bool(torch.equal(got_ax, fixed))
    ax_err = float((got_ax - want_ax).abs().max())

    def write():
        step.write_cost_eff(xs, inv_tau)

    def plain():
        costs = [torch.sub(c, torch.mul(x, inv_tau)) for c, x in zip(step.costs, xs)]
        slabs = [kdo.Slab(s.idx, s.coeff, c, s.mask) for s, c in zip(step.slabs, costs)]
        return kref.dual_oracle_call_ref(slabs, y, inv_tau, J)

    call = lambda: kops.fused_pdhg_step_call(step, xs, y, tau)  # noqa: E731
    slots = sum(b.idx.numel() for b in inst.buckets)
    # idx, m coeff, c, mask and x read, x+ written per slot; y read, A x written
    byts = slots * (4 * (m + 4) + 4) + 4 * m * J * 2
    ops = sum(slab_ops(b, m) for b in inst.buckets) + 2 * slots
    step_ms, step_kernels = device_events(call, 20)
    out = {
        "phase": "pdhg_step", "slots": slots, "tau": tau, "inv_tau": inv_tau,
        "oracle_launches_per_step": per_step[0], "finalize_launches_per_step": per_step[1],
        "cost_eff_launches_per_step": 2 * len(step.slabs),
        "device_kernels_per_step": step_kernels,
        "x_bitwise_equal_buckets": sum(ex for _, ex in x_held),
        "x_max_abs_err": max(e for e, _ in x_held), "buckets": len(step.slabs),
        "ax_bitwise_fixed_point": ax_exact, "ax_max_abs_err_vs_fp32_plain": ax_err,
        "cost_eff_bitwise_cpu_buckets": cost_eff_equal,
        "kernel_ms": event_ms(call, 30), "device_ms": step_ms,
        "oracle_device_ms": device_ms(call, 20, r"oracle_(narrow|wide|finalize)"),
        "cost_eff_write_ms": event_ms(write, 30), "cost_eff_write_device_ms":
            device_events(write, 20)[0],
        "host_enqueue_ms": host_ms(call),
        "plain_ms": event_ms(plain, 5),
        "bytes": byts, "fp32_ops": ops, **bound_of(byts, ops),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the prox step",
    }
    emit(out)
    if per_step != (step.launches_per_call, 1) or step.launches_per_call != 1:
        fail(f"pdhg step launched {per_step} (oracle, finalize), expected (1, 1)")
    if out["x_bitwise_equal_buckets"] != len(step.slabs) or not ax_exact:
        fail(f"pdhg step against its plain version: {out}")
    if cost_eff_equal != len(step.slabs):
        fail(f"cost_eff on the card differs from the CPU's in "
             f"{len(step.slabs) - cost_eff_equal} buckets")
    return out


def device_events(fn, reps: int) -> tuple:
    """Device ms per call of `fn` over all its device events and the number
    of device events per call, from a torch.profiler trace of `reps` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that lost the window's device events is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU
                and e.self_device_time_total > 0]
        if rows:
            return (sum(e.self_device_time_total for e in rows) / 1e3 / reps,
                    sum(e.count for e in rows) / reps)
    return "not measured", "not measured"


def phase_formulation_path(main) -> dict:
    """The capacity-cap formulation compiled at the main path's instance and
    solved through the AGD engine with the unfused oracle: no kernel runs
    (the box-cut projection is plain PyTorch); its time, g, matched value
    and violation, and the cap held."""
    import torch

    from repro_torch.engines import resolve_engine
    from repro_torch.formulation import scenario_formulation

    r = main["run"]
    comp = scenario_formulation("capacity-cap").compile(r.instance)
    cfg = r.config
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    raw = resolve_engine("agd").raw_solve(
        comp.instance, torch.zeros(comp.instance.dual_dim, device="cuda"), cfg,
        normalize=False)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    iters = int(raw.iters.sum())
    cap = comp.formulation.feasible_tuple[0].cap
    x_max = max(float(x.max()) for x in raw.x_slabs)
    out = {
        "phase": "formulation_path", "formulation": comp.spec.name, "cap": cap,
        "engine": "agd", "oracle": "unfused", "iterations": iters,
        "ms_per_iter": solve_s / iters * 1e3, "g": float(raw.g),
        "value": matched_value(r, raw.x_slabs),
        "max_violation": float(raw.stats[-1].max_violation[-1]), "x_max": x_max,
        "launch_counts": counts,
    }
    emit(out)
    if any(counts.values()):
        fail(f"the formulation path launched a kernel: {counts}")
    if not all(math.isfinite(out[k]) for k in ("g", "value", "max_violation")):
        fail(f"non-finite formulation result {out}")
    if not x_max <= cap + 1e-5:
        fail(f"capacity cap {cap} broken: max x {x_max}")
    return out


def random_delta(edges, rng, *, frac_update=0.02, n_insert=3, n_delete=3, rhs_jitter=0.02):
    """The reference service CLI's delta (`launch/service.py` `_random_delta`):
    value updates of `frac_update` of the edges, `n_insert` new edges,
    `n_delete` deleted ones and an rhs jittered by `rhs_jitter`."""
    import numpy as np

    from repro_torch.instances import InstanceDelta

    spec = edges.spec
    m, J, I = spec.num_families, spec.num_destinations, spec.num_sources
    nnz = edges.nnz
    n_upd = max(1, int(frac_update * nnz))
    perm = rng.permutation(nnz)
    upd, dele = perm[:n_upd], perm[n_upd: n_upd + n_delete]
    existing = set((edges.src * J + edges.dst).tolist())
    ins_s, ins_d = [], []
    while len(ins_s) < n_insert:
        s, d = int(rng.integers(I)), int(rng.integers(J))
        if s * J + d not in existing:
            existing.add(s * J + d)
            ins_s.append(s)
            ins_d.append(d)
    return InstanceDelta(
        insert_src=ins_s, insert_dst=ins_d,
        insert_values=rng.uniform(0.1, 3.0, n_insert),
        insert_coeff=rng.uniform(0.1, 2.0, (m, n_insert)),
        delete_src=edges.src[dele], delete_dst=edges.dst[dele],
        update_src=edges.src[upd], update_dst=edges.dst[upd],
        update_values=edges.values[upd] * rng.uniform(0.9, 1.1, n_upd),
        rhs=np.asarray(edges.rhs) * rng.uniform(1 - rhs_jitter, 1 + rhs_jitter, m * J),
    )


def restart_triggers(stats) -> list:
    """Iterations of each stage whose g fell below the previous one's: the
    adaptive restart's trigger, which resets the momentum."""
    return [int((st.g[1:] < st.g[:-1]).sum()) for st in stats]


def instance_bits_equal(a, b) -> bool:
    """Every leaf of two instances equal bit for bit."""
    import torch

    from repro_torch.service.engine import _leaves

    bits = lambda t: t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)
    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(bits(x), bits(y))
               for x, y in zip(_leaves(a), _leaves(b)))


def phase_cadence_path(main) -> dict:
    """The recurring-solve cadence at the main path's instance, through the
    port's entry points as the reference's service composes them: a
    `DeltaIngestor` (row headroom 8), `device_put_instance`, then three
    cadences of `compiled_solver` with Jacobi normalization and the fused
    oracle (kernel 1 in every AGD iteration):
      0 cold: the main path's six gamma stages x 100 iterations (fixed budget,
        so the launch counts are exact);
      1 the reference CLI's mixed delta (2% of the edges' values, 3 inserts,
        3 deletes, the rhs jittered by 2%), replayed with `apply_scatter_plan`,
        solved warm from cadence 0's lam over (0.1, 0.01) x 100 with the power
        iteration, and held against the same warm solve with the unfused
        oracle: g within 1e-5 rel, and lam within 1e-4 rel-L2 for the same
        pair without adaptive restart, whose g < g_prev test flips on
        near-ties and parts the two trajectories along a flat direction;
      2 the same generator's cost-only delta (no inserts or deletes),
        replayed, solved warm with `compiled_solver_fixed_sigma` and cadence
        1's sigma^2.
    After each replay every leaf is bitwise a fresh upload of the host slabs
    and the pre-replay instance is unchanged.  Drift, the gamma bound (held
    on cadence 2, where A is unchanged, in tests/test_stability.py's form),
    the convergence traces, the stall detector and the Prometheus text are
    reported; times are host-clocked and end in torch.cuda.synchronize()."""
    import numpy as np
    import torch

    from repro_torch import telemetry
    from repro_torch.core import MatchingObjective, MaximizerConfig, drift_bound, primal_drift
    from repro_torch.core.objective import normalize_rows_traced
    from repro_torch.instances import DeltaIngestor
    from repro_torch.service import (
        apply_scatter_plan, compile_cache_report, compiled_solver,
        compiled_solver_fixed_sigma, device_put_instance, instance_nbytes, to_solve_result,
    )
    from repro_torch.telemetry import ConvergenceTrace, MetricsRegistry, StallDetector

    r = main["run"]
    edges = r.edges
    telemetry.set_registry(MetricsRegistry())  # this phase's counters alone
    cold_cfg = MaximizerConfig(iters_per_stage=100)
    warm_cfg = MaximizerConfig(gammas=(0.1, 0.01), iters_per_stage=100)

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = fn()
        torch.cuda.synchronize()
        return v, time.perf_counter() - t0

    ing, build_s = clock(lambda: DeltaIngestor(edges, row_headroom=8))
    dev, upload_s = clock(lambda: device_put_instance(ing.instance()))
    per_call = 1 + sum(b.length > 32 for b in dev.buckets)
    rng = np.random.default_rng(17)
    detector = StallDetector()
    cadences, launches, finalizes = [], 0, 0

    def solve(k, mode, fn, *args):
        nonlocal launches, finalizes
        torch.cuda.synchronize()
        reset_counts()
        raw, solve_s = clock(lambda: fn(*args))
        counts = read_counts()
        res = to_solve_result(raw)
        iters = int(sum(res.iters_used))
        trace = ConvergenceTrace.from_result(res, tenant="t0", cadence=k, mode=mode)
        trace.record()
        launches += counts["dual_oracle"]
        finalizes += counts["dual_oracle_finalize"]
        out = {"cadence": k, "mode": mode, "solve_s": solve_s, "iterations": iters,
               "ms_per_iter": solve_s / iters * 1e3, "g": float(res.g),
               "sigma_sq": float(res.sigma_sq), "launch_counts": counts,
               "oracle_calls": iters + 1, "power_iteration_oracle_calls": 0,
               "expected_oracle_launches": per_call * (iters + 1),
               "stall_flagged": detector.observe(trace), "convergence": trace.summary()}
        if (counts["dual_oracle"] != per_call * (iters + 1)
                or counts["dual_oracle_finalize"] != iters + 1
                or counts["dual_primal"] or counts["simplex_proj"] or counts["width_routed"]):
            fail(f"cadence {k} launches {counts}: expected {per_call * (iters + 1)} oracle "
                 f"launches and {iters + 1} finalizes (every AGD iteration and the final "
                 f"calculate; the power iteration runs A and A^T unfused)")
        if not (math.isfinite(out["g"]) and all(bool(torch.isfinite(x).all())
                                                 for x in res.x_slabs)):
            fail(f"cadence {k}: non-finite result {out}")
        return res, out

    zero = torch.zeros(dev.dual_dim, device="cuda")
    res0, c0 = solve(0, "cold", compiled_solver(cold_cfg, normalize=True, fused_oracle=True),
                     dev, zero)
    c0.update(build_s=build_s, upload_s=upload_s, instance_nbytes=instance_nbytes(dev),
              nnz=ing.nnz, headroom_rows=ing.headroom(), dc_norm=ing.drain_cost_drift())
    cadences.append(c0)
    prev, prev_res = dev, res0
    for k, (n_ins, n_del) in ((1, (3, 3)), (2, (0, 0))):
        cur = ing.to_edge_list()
        delta, gen_s = clock(lambda: random_delta(cur, rng, n_insert=n_ins, n_delete=n_del))
        rep, ingest_s = clock(lambda: ing.apply(delta))
        if not rep.in_place:
            fail(f"cadence {k}: the delta fell back to a re-bucketize ({rep.fallback_reason})")
        before = device_put_instance(prev)
        new, replay_s = clock(lambda: apply_scatter_plan(prev, rep.plan))
        replay_equal = instance_bits_equal(new, device_put_instance(ing.instance()))
        input_kept = instance_bits_equal(prev, before)
        del before
        if not (replay_equal and input_kept):
            fail(f"cadence {k}: replay bitwise the host slabs {replay_equal}, "
                 f"pre-replay instance unchanged {input_kept}")
        replay_event_ms = event_ms(lambda: apply_scatter_plan(prev, rep.plan), 10, warmup=1)
        replay_device_ms, replay_events = device_events(
            lambda: apply_scatter_plan(prev, rep.plan), 5)
        dc = ing.drain_cost_drift()
        if k == 1:
            power_s = clock(lambda: MatchingObjective(normalize_rows_traced(new)[0])
                            .power_iteration(warm_cfg.seed, iters=warm_cfg.power_iters))[1]
            res, c = solve(k, "warm", compiled_solver(warm_cfg, normalize=True,
                                                      fused_oracle=True), new, prev_res.lam)
            unfused, unfused_s = clock(lambda: compiled_solver(
                warm_cfg, normalize=True, fused_oracle=False)(new, prev_res.lam))
            # the same pair without adaptive restart: the restart test
            # g < g_prev flips on near-ties of g, so with it on the two
            # trajectories part for reasons other than A x's rounding
            plain_cfg = dataclasses.replace(warm_cfg, adaptive_restart=False)
            fixed = [compiled_solver(plain_cfg, normalize=True, fused_oracle=f)(
                new, prev_res.lam) for f in (True, False)]
            c.update(power_iteration_s=power_s, power_iteration_share=power_s / c["solve_s"],
                     unfused_solve_s=unfused_s,
                     rel_l2_lam_fused_vs_unfused=rel_l2(res.lam, unfused.lam),
                     rel_g_fused_vs_unfused=rel_diff(res.g, unfused.g),
                     restart_triggers_fused_vs_unfused=[restart_triggers(res.stats),
                                                        restart_triggers(unfused.stats)],
                     no_restart_rel_l2_lam_fused_vs_unfused=rel_l2(fixed[0].lam, fixed[1].lam),
                     no_restart_rel_g_fused_vs_unfused=rel_diff(fixed[0].g, fixed[1].g))
            if not (c["no_restart_rel_l2_lam_fused_vs_unfused"] <= 1e-4
                    and c["rel_g_fused_vs_unfused"] <= 1e-5):
                fail(f"cadence 1: warm fused vs unfused beyond lam 1e-4 rel-L2 (without "
                     f"adaptive restart) or g 1e-5 rel (with it): {c}")
        else:
            res, c = solve(k, "warm", compiled_solver_fixed_sigma(
                warm_cfg, normalize=True, fused_oracle=True), new, prev_res.lam,
                prev_res.sigma_sq)
        drift = float(primal_drift(res.x_slabs, prev_res.x_slabs))
        x_norm = float(torch.linalg.vector_norm(torch.cat([x.reshape(-1) for x in res.x_slabs])))
        dlam = float(torch.linalg.vector_norm(res.lam - prev_res.lam))
        sigma = math.sqrt(float(res.sigma_sq))
        c.update(delta_generate_s=gen_s, ingest_host_ms=ingest_s * 1e3,
                 n_update=rep.n_update, n_insert=rep.n_insert, n_delete=rep.n_delete,
                 moved_rows=rep.moved_rows, plan_cells=rep.plan.num_cells,
                 plan_runs=rep.plan.num_runs, plan_nbytes=rep.plan.nbytes,
                 instance_nbytes=instance_nbytes(new),
                 plan_share_of_upload=rep.plan.nbytes / instance_nbytes(new),
                 replay_s=replay_s, replay_event_ms=replay_event_ms,
                 replay_device_ms=replay_device_ms, replay_device_events=replay_events,
                 replay_bitwise_host=replay_equal, pre_replay_unchanged=input_kept,
                 generation=rep.generation, drift_l2=drift,
                 drift_rel=drift / max(x_norm, 1e-12), dc_norm=dc, dlam_l2=dlam,
                 drift_bound=drift_bound(warm_cfg.gammas[-1], dc, dlam, sigma))
        if k == 2:
            # A is unchanged: the bound of tests/test_stability.py holds
            bound = drift_bound(warm_cfg.gammas[-1], dc * 1.5, dlam, sigma)
            c["drift_within_bound"] = drift <= bound * 1.1
            if not c["drift_within_bound"]:
                fail(f"cadence 2 drift {drift} beyond the gamma bound {bound} x 1.1")
        cadences.append(c)
        prev, prev_res = new, res
    for c in cadences:
        emit({"phase": "cadence", **c})
    text = telemetry.prometheus_text()
    names = sorted({ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")})
    out = {"phase": "cadence_path", "sources": edges.spec.num_sources,
           "oracle_launches": launches, "stall_flagged": sorted(detector.flagged),
           "compile_cache": compile_cache_report(),
           "prometheus_bytes": len(text), "prometheus_metrics": names,
           "counters": telemetry.get_registry().snapshot()["counters"]}
    print("prometheus: " + " ".join(names), flush=True)
    emit(out)
    return {"launches": launches, "finalizes": finalizes, "cadences": cadences}


def phase_coo_pdhg(main, pdhg) -> dict:
    """The unstructured COO PDHG baseline (the paper's comparator): at the
    main path's instance for a fixed budget of 600 iterations, checks every
    50 (as benchmarks/table3_vs_pdhg.py runs it), twice with equal bits, its
    ms per iteration beside the structured PDHG path's, its residuals and
    the device memory of its matrix, and its K x and K'y (exact int64
    fixed-point sums) each timed beside the same sums by
    torch.segment_reduce; then tests/test_pdhg.py's instance
    (60 x 10, nu = 4) to convergence against scipy's HiGHS (primal objective
    within rel 5e-3).  No kernel of the port runs here."""
    import numpy as np
    import torch
    from scipy.optimize import linprog

    from repro_torch.core import PDHGConfig, from_edge_list, solve_pdhg
    from repro_torch.instances import MatchingInstanceSpec, generate_matching_instance

    edges = main["run"].edges
    m = edges.spec.num_families
    entries = (m + 1) * edges.nnz
    rows = m * edges.spec.num_destinations + edges.spec.num_sources
    # the COO arrays (int32 rows, cols, fp32 vals), each order's int64 index
    # and fp32 values and its int64 segment ends, and c, q, u
    reckoned = (entries * 12 + 2 * entries * 12 + 8 * (rows + edges.nnz)
                + 4 * (2 * edges.nnz + rows))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lp = from_edge_list(edges)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mem = torch.cuda.memory_allocated() - mem0
    cfg = PDHGConfig(max_iters=600, tol=0.0, check_every=50)
    reset_counts()
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_pdhg(lp, cfg)
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0))
    counts = read_counts()
    (a, a_s), (b, b_s) = runs
    same = torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    x = torch.rand(lp.num_cols, device="cuda")
    y = torch.rand(lp.num_rows, device="cuda")

    def segment_reduce(order, v):  # the same sums by torch.segment_reduce
        offsets = torch.cat([order.ends.new_zeros(1), order.ends])
        return torch.segment_reduce(order.vals * v[order.other], "sum", offsets=offsets,
                                    unsafe=True)

    split = pdhg.get("split", {}).get("not_cli_check_every_50", {})
    out = {
        "phase": "coo_pdhg", "nnz": edges.nnz, "entries": entries, "rows": rows,
        "build_s": build_s, "matrix_bytes": lp.nbytes, "reckoned_bytes": reckoned,
        "allocated_bytes": mem, "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "iterations": a.iters, "solve_s_readings": [a_s, b_s],
        "ms_per_iter": min(a_s, b_s) / a.iters * 1e3,
        "matvec_pair_ms": event_ms(lambda: lp.KT(lp.K(x)), 20),
        "K_ms": event_ms(lambda: lp.K(x), 20), "KT_ms": event_ms(lambda: lp.KT(y), 20),
        "segment_reduce_K_ms": event_ms(lambda: segment_reduce(lp._by_row, x), 5),
        "segment_reduce_KT_ms": event_ms(lambda: segment_reduce(lp._by_col, y), 5),
        "K_rel_err_vs_segment_reduce": rel_l2(lp.K(x), segment_reduce(lp._by_row, x)),
        "structured_pdhg_ms_per_iter_check_every_25": pdhg["summary"]["ms_per_iter"],
        "structured_pdhg_ms_per_iter_check_every_50": split.get("ms_per_iter"),
        "primal_obj": float(a.primal_obj), "dual_obj": float(a.dual_obj),
        "rel_gap": float(a.rel_gap), "primal_res": float(a.primal_res),
        "dual_res": float(a.dual_res), "bitwise_equal_runs": same, "launch_counts": counts,
    }
    del lp, runs, a, b
    small = generate_matching_instance(MatchingInstanceSpec(
        num_sources=60, num_destinations=10, avg_degree=4.0, seed=5))
    t0 = time.perf_counter()
    sres = solve_pdhg(from_edge_list(small), PDHGConfig(max_iters=40_000))
    small_s = time.perf_counter() - t0
    A, bvec, c = small.to_dense()
    J = small.spec.num_destinations
    cols = small.src * J + small.dst
    S = np.zeros((small.spec.num_sources, small.nnz))
    S[small.src, np.arange(small.nnz)] = 1.0
    lpres = linprog(c[cols], A_ub=np.vstack([A[:, cols], S]),
                    b_ub=np.concatenate([bvec, np.ones(small.spec.num_sources)]),
                    bounds=(0, 1), method="highs")
    rel = abs(float(sres.primal_obj) - lpres.fun) / abs(lpres.fun)
    out["small"] = {"iterations": sres.iters, "converged": bool(sres.converged),
                    "solve_s": small_s, "primal_obj": float(sres.primal_obj),
                    "highs_obj": float(lpres.fun), "rel_vs_highs": rel}
    emit(out)
    if not same:
        fail("two COO PDHG solves on the card differ in their bits")
    if any(counts.values()):
        fail(f"the COO PDHG baseline launched a kernel: {counts}")
    if not all(math.isfinite(out[k]) for k in ("primal_obj", "dual_obj", "primal_res",
                                               "dual_res", "rel_gap")):
        fail(f"non-finite COO PDHG result {out}")
    if not (out["small"]["converged"] and rel < 5e-3):
        fail(f"COO PDHG on the 60 x 10 instance against HiGHS: {out['small']}")
    return out


def slab_ops(b, m) -> int:
    """fp32 operations one oracle or primal call needs on bucket b: the
    candidate (2m + 2), the segment's sort, scan and cut, the projection,
    and (the oracle) m contributions and two partials per slot."""
    lg = int(math.log2(b.length))
    return b.idx.numel() * (2 * m + 2 + lg * (lg + 1) // 2 * 2 + lg + 8 + 2 * m + 4)


def phase_times(main) -> dict:
    """The oracle at the main path's shapes: each bucket alone (its own
    one-bucket plan: one oracle launch and a finalize) and the whole call
    (the main path's plan), held against the plain versions, timed by CUDA
    events against their bounds; the finalize alone the same way; then the
    profile of the main path's iterations."""
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
    atol = X_ATOL[inst.slab_dtype]
    call_bytes = 4 * m * J * 2 + 8  # lam read, A x and (c'x, ||x||^2) written

    def bound(byts, ops):
        return {"bytes": byts, "fp32_ops": ops, **bound_of(byts, ops)}

    rows = []
    for b in inst.buckets:
        plan1 = kdo.plan_slabs("dual_oracle", [b], J)
        (x,), ax, _, _ = kdo.oracle_call(plan1, lam, gamma)
        want = kref.dual_oracle_ref(b.idx, b.coeff, b.cost, b.mask, lam, gamma, J)
        err, exact = held(x, want[0], atol)
        reps = 50 if b.idx.numel() > 100_000 else 200
        rows.append({
            "L": b.length, "rows": b.rows, "slots": b.idx.numel(),
            "x_max_abs_err": err, "x_bitwise_equal": exact,
            "ax_bitwise_fixed_point": bool(torch.equal(ax, kref.fixed_point_hist(
                [b], lam, gamma, J, plan1.shift))),
            "launch": launch_summary(plan1.launches[0]),
            "kernel_ms": event_ms(lambda: kdo.oracle_call(plan1, lam, gamma), reps),
            "plain_ms": event_ms(
                lambda: kref.dual_oracle_ref(b.idx, b.coeff, b.cost, b.mask, lam, gamma, J),
                max(5, reps // 10)),
            **bound(b.idx.numel() * slot_bytes + call_bytes, slab_ops(b, m)),
        })
    for row in rows:
        emit({"phase": "times_bucket", **row})
    if not all(row["ax_bitwise_fixed_point"] for row in rows):
        fail("a main-path bucket's A x differs from the fixed-point plain sum")

    # the whole call of the main path's plan, held and timed
    plan = r.objective.kernel_plan("dual_oracle")
    scratch = {}
    xs, ax, lin, sq = kdo.oracle_call(plan, lam, gamma, scratch=scratch)
    want = kref.dual_oracle_call_ref(inst.buckets, lam, gamma, J)
    fixed = kref.fixed_point_hist(inst.buckets, lam, gamma, J, plan.shift)
    held_x = [held(x, w, atol) for x, w in zip(xs, want[0])]
    errs = {name: float((a - w).abs().max()) for a, w, name in
            zip((ax, lin, sq), want[1:], ("ax", "lin", "sq"))}
    if not all(bool(((a - w).abs() <= 3e-5 + 1e-5 * w.abs()).all())
               for a, w in zip((ax, lin, sq), want[1:])):
        fail(f"whole oracle call against the plain call beyond atol 3e-5 + rtol 1e-5: {errs}")
    second = kdo.oracle_call(plan, lam, gamma)
    rerun = (all(torch.equal(a, c) for a, c in zip(xs, second[0]))
             and all(torch.equal(a, c) for a, c in zip((ax, lin, sq), second[1:])))
    if not (rerun and torch.equal(ax, fixed)):
        fail(f"whole call: rerun bitwise {rerun}, A x bitwise the fixed-point sum "
             f"{bool(torch.equal(ax, fixed))}")
    slots = sum(b.idx.numel() for b in inst.buckets)
    out = {
        "phase": "times_call",
        "launches_per_call": len(plan.launches), "launch": launch_summary(plan.launches[0]),
        "fixed_point_shift": plan.shift,
        "kernel_ms": event_ms(lambda: kdo.oracle_call(plan, lam, gamma), 30),
        "host_enqueue_ms": host_ms(lambda: kdo.oracle_call(plan, lam, gamma)),
        "fused_dual_oracle_call_ms": event_ms(lambda: kops.fused_dual_oracle_call(
            inst.buckets, lam, gamma, num_destinations=J, plan=plan), 30),
        "plain_ms": event_ms(lambda: kref.dual_oracle_call_ref(inst.buckets, lam, gamma, J), 5),
        **bound(slots * slot_bytes + call_bytes, sum(slab_ops(b, m) for b in inst.buckets)),
        "main_path_x_max_abs_err": max(e for e, _ in held_x),
        "main_path_x_bitwise_equal_buckets": sum(x for _, x in held_x),
        "ax_lin_sq_max_abs_err_vs_plain": errs,
        "ax_bitwise_fixed_point": True, "bitwise_equal_rerun": rerun,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused oracle",
    }
    emit(out)

    # the finalize alone, on the int64 row and partials the whole call left
    acc, scal = scratch["acc"], scratch["scal"]
    fax, flin_sq = kdo.oracle_finalize(acc, scal, plan.shift, plan.finalize_grid)
    plain_fin = lambda: (acc.to(torch.float32) * 2.0 ** -plan.shift, scal.sum(0))
    pax, plin_sq = plain_fin()
    torch.cuda.synchronize()
    fin_err = float((flin_sq - plin_sq).abs().max())
    if not (torch.equal(fax, ax) and torch.equal(fax, pax)
            and bool(((flin_sq - plin_sq).abs() <= 3e-5 + 1e-5 * plin_sq.abs()).all())):
        fail(f"finalize against its plain version: A x bitwise {bool(torch.equal(fax, pax))}, "
             f"(c'x, ||x||^2) error {fin_err}")
    fin = {
        "phase": "times_finalize", "scal_rows": plan.scal_rows,
        "grid": plan.finalize_grid, "ax_bitwise_plain": True, "lin_sq_max_abs_err": fin_err,
        "kernel_ms": event_ms(lambda: kdo.oracle_finalize(acc, scal, plan.shift,
                                                          plan.finalize_grid), 200),
        "plain_ms": event_ms(plain_fin, 50),
        **bound(acc.numel() * 8 + scal.numel() * 4 + 4 * m * J + 8, acc.numel() + scal.numel()),
        "library_ms": None,
        "library_note": "no single PyTorch call turns the int64 row into scaled fp32 "
                        "and sums the partials",
    }
    emit(fin)
    emit(profile_iterations(local_calculate(r.objective), r.result.lam,
                            r.config.gammas[-1], "main"))
    return {"call": out, "finalize": fin}


def device_ms(fn, reps: int, pattern: str) -> float:
    """Device time per call of `fn` spent in the kernels whose name matches
    `pattern`, from a torch.profiler trace of `reps` calls (the kernels'
    own time, free of the host's launch overhead)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that lost the window's device events is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type != DeviceType.CPU and re.search(pattern, e.key))
        if us > 0:
            return us / 1e3 / reps
    return "not measured"


SIMPLEX_KERNELS = r"simplex_(narrow|wide)"


def phase_times_primal_simplex(main) -> dict:
    """The primal-step and simplex kernels at the main path's shapes: per
    bucket (one-bucket plans) and per call (all buckets, one launch), by
    CUDA events and, for the simplex kernel, by device time from the
    profiler, against their plain versions and their HBM bounds.  The
    simplex kernel projects the unfused oracle's primal candidates at the
    main path's final duals, in fp32 (the path's) and in bf16."""
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
    bytes2 = lambda b: b.idx.numel() * slot2
    ops2 = lambda b: b.idx.numel() * (2 * m + 2 + sort_scan(lg(b)))
    # the simplex kernel: v and mask read, out written, per slot
    bytes3 = lambda b, size=4: b.idx.numel() * 3 * size
    ops3 = lambda b: b.idx.numel() * sort_scan(lg(b))
    lam2 = lam.reshape(m, J)
    ginv = inv_gamma(gamma)
    vs = [-(gather_at_lam(b.coeff, b.idx, lam2) + b.cost) * ginv for b in inst.buckets]
    masks = [b.mask for b in inst.buckets]
    plain2 = lambda b: kref.dual_primal_ref(b.idx, b.coeff, b.cost, b.mask, lam, gamma, J)
    plans2 = [kdo.plan_slabs("dual_primal", [b], J) for b in inst.buckets]
    whole2 = kdo.plan_slabs("dual_primal", inst.buckets, J)
    plans3 = [ksp.plan_simplex([tuple(v.shape)], v.dtype, v.device) for v in vs]
    whole3 = kops.plan_slab_kernel("simplex_proj", inst.buckets, J)
    if len(whole3.launches) != 1:
        fail(f"simplex plan of the main path in {len(whole3.launches)} launches")

    # each kernel at the main path's shapes against its plain version
    atol = X_ATOL[inst.slab_dtype]
    held_by = {"primal": [], "simplex": []}
    xs = kdp.primal_call(whole2, lam, gamma)
    ws = ksp.simplex_call(whole3, vs, masks)
    for b, v, x, w in zip(inst.buckets, vs, xs, ws):
        held_by["primal"].append(held(x, plain2(b), atol))
        held_by["simplex"].append(held(w, kref.simplex_ref(v, b.mask), atol))
    oracle_xs = kdo.oracle_call(r.objective.kernel_plan("dual_oracle"), lam, gamma)[0]
    x_equal = all(torch.equal(a, c) for a, c in zip(xs, oracle_xs))
    if not x_equal:
        fail("primal kernel's x differs from the oracle's on the main path's buckets")
    if not all(exact for _, exact in held_by["simplex"]):
        fail("simplex kernel's x differs from the plain version's on the main path's buckets")

    rows = []
    for b, v, p2, p3 in zip(inst.buckets, vs, plans2, plans3):
        reps = 50 if b.idx.numel() > 100_000 else 200
        one3 = lambda: ksp.simplex_call(p3, [v], [b.mask])
        rows.append({
            "L": b.length, "rows": b.rows, "slots": b.idx.numel(),
            "primal_launch": launch_summary(p2.launches[0]),
            "primal_kernel_ms": event_ms(lambda: kdp.primal_call(p2, lam, gamma), reps),
            "primal_plain_ms": event_ms(lambda: plain2(b), max(5, reps // 10)),
            "primal_bound_ms": max((bytes2(b) + 4 * m * J) / HBM_BYTES_PER_S,
                                   ops2(b) / FP32_FLOPS) * 1e3,
            "simplex_launch": simplex_launch_summary(p3.launches[0]),
            "simplex_kernel_ms": event_ms(one3, reps),
            "simplex_device_ms": device_ms(one3, 20, SIMPLEX_KERNELS),
            "simplex_plain_ms": event_ms(lambda: kref.simplex_ref(v, b.mask),
                                         max(5, reps // 10)),
            "simplex_bound_ms": max(bytes3(b) / HBM_BYTES_PER_S, ops3(b) / FP32_FLOPS) * 1e3,
        })
    for row in rows:
        emit({"phase": "times_bucket_primal_simplex", **row})

    def over_buckets(fn):  # one call: every bucket once
        return lambda: [fn(i) for i in range(len(inst.buckets))]

    out = {"phase": "times_call_primal_simplex", "library_ms": None,
           "library_note": "no single PyTorch call computes either function",
           "primal_launch": launch_summary(whole2.launches[0]),
           "simplex_launch": simplex_launch_summary(whole3.launches[0]),
           "x_bitwise_equal_oracle": x_equal}
    for name, bytes_fn, ops_fn, extra in (("primal", bytes2, ops2, 4 * m * J),
                                          ("simplex", bytes3, ops3, 0)):
        byts = sum(bytes_fn(b) for b in inst.buckets) + extra
        ops = sum(ops_fn(b) for b in inst.buckets)
        out[name] = {"bytes": byts, "fp32_ops": ops, **bound_of(byts, ops)}
        out[name]["main_path_max_abs_err"] = max(e for e, _ in held_by[name])
        out[name]["main_path_bitwise_equal_buckets"] = sum(x for _, x in held_by[name])
    out["primal"]["kernel_ms"] = event_ms(lambda: kdp.primal_call(whole2, lam, gamma), 30)
    out["primal"]["host_enqueue_ms"] = host_ms(lambda: kdp.primal_call(whole2, lam, gamma))
    out["primal"]["plain_ms"] = event_ms(over_buckets(lambda i: plain2(inst.buckets[i])), 5)
    call3 = lambda: ksp.simplex_call(whole3, vs, masks)
    # the same call with L2 (50 MB) flushed before each: a 128 MB write
    # evicts what the previous call left there, so every call reads its
    # 131 MB from HBM, as the bound charges (3 x 4 B per slot: v and mask
    # read and x written for every row, all-padding rows included)
    flush = torch.empty(32 * 2**20, device=vs[0].device)
    out["simplex"].update(
        kernel_ms=event_ms(call3, 30), device_ms=device_ms(call3, 20, SIMPLEX_KERNELS),
        device_ms_l2_flushed=device_ms(lambda: (flush.fill_(1.0), call3()), 20,
                                       SIMPLEX_KERNELS),
        host_enqueue_ms=host_ms(call3),
        fused_project_simplex_call_ms=event_ms(lambda: kops.fused_project_simplex_call(
            vs, masks, plan=whole3), 30),
        plain_ms=event_ms(over_buckets(lambda i: kref.simplex_ref(vs[i], masks[i])), 5))
    # the same call in bf16: half the bytes; the same time would mean the
    # kernel is bound by its instructions, not by HBM
    vs16 = [v.bfloat16() for v in vs]
    masks16 = [mk.bfloat16() for mk in masks]
    whole16 = ksp.plan_simplex([tuple(v.shape) for v in vs], torch.bfloat16, vs[0].device)
    ws16 = ksp.simplex_call(whole16, vs16, masks16)
    held16 = [held(w, kref.simplex_ref(v, mk), X_ATOL["bfloat16"])
              for w, v, mk in zip(ws16, vs16, masks16)]
    if not all(exact for _, exact in held16):
        fail("simplex kernel's bf16 x differs from the plain version's on the main path")
    byts16 = sum(bytes3(b, 2) for b in inst.buckets)
    call16 = lambda: ksp.simplex_call(whole16, vs16, masks16)
    out["simplex_bf16"] = {
        "bytes": byts16, "fp32_ops": out["simplex"]["fp32_ops"],
        **bound_of(byts16, out["simplex"]["fp32_ops"]),
        "main_path_max_abs_err": max(e for e, _ in held16),
        "main_path_bitwise_equal_buckets": sum(x for _, x in held16),
        "kernel_ms": event_ms(call16, 30), "device_ms": device_ms(call16, 20, SIMPLEX_KERNELS),
        "plain_ms": event_ms(over_buckets(lambda i: kref.simplex_ref(vs16[i], masks16[i])), 5),
    }
    emit(out)
    return out


def bound_of(byts: int, ops: int) -> dict:
    """The least time of a function that moves `byts` HBM bytes and does
    `ops` fp32 operations, and which of the two bounds it."""
    b_ms, o_ms = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return {"bytes_bound_ms": b_ms, "ops_bound_ms": o_ms, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def profile_iterations(calculate, lam, gamma: float, tag: str, iters: int = 20) -> dict:
    """`profile_window` over `iters` AGD iterations of `calculate` at duals
    `lam`."""
    import torch

    from repro_torch.core.maximizer import _stage_scan

    eta = torch.full((), 1e-3, device=lam.device)
    return profile_window(lambda: _stage_scan(calculate, lam, gamma, eta, iters,
                                              acceleration=True, adaptive_restart=True),
                          tag, iters)


def profile_window(step, tag: str, iters: int) -> dict:
    """Device busy share of a window of `iters` iterations (one call of
    `step`), from a torch.profiler trace: the summed time of the device's
    own events (kernels, copies, fills) over the host-clocked wall time of
    the window, each kernel of the port per iteration (one instantiation per
    bucket width: the bucket's device time, free of the host's launch
    overhead that the event timing of a small bucket measures), and the top
    device events.  Host-side ops (`aten::*`) also carry the device time of
    the kernels they launch; they are left out, or it would count twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
               if (m := re.search(r"(oracle|primal|simplex)_(narrow|wide|finalize)(<[^>]*>)?", k))]
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

    timed(phase_kernel_info, ptxas_summary(build.build_logs))

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
    pdhg = timed(phase_pdhg_path, args.sources)
    pdhg_step = timed(phase_pdhg_step, pdhg)
    timed(phase_formulation_path, main_path)
    times = timed(phase_times, main_path)
    times23 = timed(phase_times_primal_simplex, main_path)
    cadence = timed(phase_cadence_path, main_path)
    timed(phase_coo_pdhg, main_path, pdhg)

    def worst(sw):
        return max(v if isinstance(v, float) else max(v.values())
                   for v in sw["worst_abs_err"].values())

    def entry(name, replaces, launches, err, t, source=None, **extra):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None, **extra}

    main_counts = main_path["summary"]["launch_counts"]
    pdhg_counts = pdhg["summary"]["launch_counts"]
    emit({"kernels": [
        entry("dual_oracle", "src/repro/kernels/dual_oracle.py:87",
              main_path["summary"]["kernel_launches"],
              max(worst(sweep), times["call"]["main_path_x_max_abs_err"],
                  pdhg_step["x_max_abs_err"]), times["call"],
              launches_by_path={"main": main_counts["dual_oracle"],
                                "pdhg": pdhg_counts["dual_oracle"],
                                "cadence": cadence["launches"]},
              pdhg_step={k: pdhg_step[k] for k in ("kernel_ms", "device_ms", "plain_ms",
                                                   "bound_ms", "bound_by")}),
        entry("dual_oracle_finalize", "src/repro/kernels/ops.py:317",
              main_counts["dual_oracle_finalize"],
              times["finalize"]["lin_sq_max_abs_err"], times["finalize"], "dual_oracle",
              launches_by_path={"main": main_counts["dual_oracle_finalize"],
                                "pdhg": pdhg_counts["dual_oracle_finalize"],
                                "cadence": cadence["finalizes"]}),
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
