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
     tests/test_pdhg.py's size against scipy's HiGHS;
  7. service_path: `python -m repro_torch.launch.service` in process, 4
     tenants at the main path's instance, `--fused-oracle --verify`, three
     cadences solved as one batched group each (kernel 1 over the tenant
     axis: one launch and one finalize per batched iteration), a checkpoint
     and a `--resume` run whose first solve is warm; the batched warm stage
     against 4 solo ones and the batched oracle call against its bound;
     serve_path: `python -m repro_torch.launch.serve` in process, 2 tenants
     at that size, 3 pipelined cadences while 2 hammer threads query on
     their own streams, every batch replayed bitwise (kernel 2 over the
     requested rows: one launch per query); the query's device time.
  8. service_pdhg_path: the service CLI in process with `--engine pdhg
     --fused-oracle`, 4 tenants at the main path's instance, a cold and a
     warm cadence, each ONE batched PDHG solve (kernel 1 with a 1/gamma per
     lane as the batched prox step: one launch and one finalize per batched
     iteration), every lane against its solo PDHG solve (y, iterations,
     restarts), the batched prox step against its bound and 4 solo steps;
     dryrun: the solver dry run of the main path's own instance (bytes per
     oracle call equal to the kernel table's bound bytes, the memory
     estimate against the main path's measured peak) and the s100M-d10K
     cells at 1 and 4 shards.
  9. the LM substrate's serving path (no kernel of the port: each phase
     holds that none of the three launched), with the solver's tensors
     released first and the peak-memory statistics reset per model:
     lm_serve_cli: `python -m repro_torch.launch.serve_lm` in process at its
     defaults (reduced qwen3-8b, 8 requests, prompt 16, 24 new tokens, 4
     slots), then with `--arch X` for each of the ten architectures, every
     request done with 24 tokens in the vocabulary; lm_qwen3_8b: qwen3-8b at
     full width and depth (36 layers) through `ServeEngine` in bf16, params
     cast once: prefill against teacher-forced decode at the reference's
     atol/rtol 0.05 in fp32 compute at full depth and in bf16 on the params
     cut to 2 layers (bf16 at full depth measured, with both bf16 paths
     against the fp32 logits), two engine runs of 8 requests (16-token
     prompts, 32 new tokens, 4 slots) with identical tokens, the 2-layer cut
     in fp32 on the card against the CPU (rtol 1e-3), and the times: ms per
     batched decode step against its bound from the weights' bytes, ms per
     prefill token, tokens per second, peak memory and the device's idle
     share over a profiled window of decode steps; lm_deepseek_v2_2l:
     deepseek-v2-236b at full width cut to 2 layers (an MLA dense prefix and
     one MoE layer of 160 experts), `router="topk"` and `"lp"`: prefill
     against decode at 0.05 with a capacity that never binds, two runs
     bit-equal at the config's capacity, `lp_route` at its properties;
     lm_mamba2: mamba2-1.3b whole, the 512-token SSD prefill against decode
     at 0.05 in fp32 at full depth and in bf16 cut to 2 layers, the engine.
 10. the LM substrate's training path (no kernel of the port either):
     lm_train_qwen3_8b: qwen3-8b at full width cut to 8 of 36 layers (the
     whole model's training state does not fit 80 GB), the 2-layer cut's
     fp32 loss and gradients on the card against the CPU, then 8 steps of
     `train_loop` (bf16 compute, fp32 masters, remat, batch 8 x 256 at the
     full vocabulary): finite losses, no retry, ms per step, tokens/s, peak
     memory, a profiled step's idle share, the step's parts and its bound;
     lm_train_cli: `python -m repro_torch.launch.train --reduced` in
     process, 30 steps, and a run resumed from that run's step-20
     checkpoint alone, its final state bitwise the uninterrupted one's.
 11. the LM substrate over a mesh (no kernel of the port either), on a
     ("data", "model") mesh of shape (1, 1) over a one-rank NCCL group:
     lm_mesh_train_qwen3_8b: the train phase's qwen3-8b cut (8 layers,
     batch 8 x 256) for 4 steps of the single-device step, then 4 of
     `make_train_step` over the mesh with `default_profile` and again with
     fsdp on, from the same seed and batches: losses and grad norms within
     1e-6 relative (and whether bitwise), the median ms of steps 2-4
     against the single-device step's, peak memory (the first step's and
     steps 2-4's apart) and a profiled step's idle share; lm_mesh_serve_qwen3_8b: qwen3-8b at full depth in bf16
     through `make_serve_fns`, a prefill of 4 prompts of 64 tokens and 16
     greedy decode steps, the tokens equal to the single-device
     `prefill`/`decode_step`'s, and ms per decode step against the single
     device's; lm_mesh_dryrun: `python -m repro_torch.launch.dryrun --arch
     qwen3-8b --shape train_4k --mesh single_pod --num-layers 4` in a child
     process (the fake process group at 256 ranks) and the cell of the mesh
     train phase
     (`--mesh host --mesh-shape 1,1 --num-layers 8 --global-batch 8
     --seq-len 256`), its per-card estimate against the measured peak.
 12. examples: the port's five examples (`examples/*_torch.py`) in process
     through their `main(argv)` at the reference's defaults, with the
     tensors of the phases before released and the launch counters set to
     0 around each (no kernel of the port runs in an example): quickstart
     (its instance, layout and g against what examples/quickstart.py
     prints, g at rtol 1e-4), production_solve at its defaults and at the
     main path's 1M x 10k (the example's own drift assertion; ms per AGD
     iteration from its day-1 seconds), lp_moe_routing (the top-k router's
     line as the reference prints it; the example's own max-load
     assertion), serve_lm (46 engine steps), train_lm at the 10m preset
     (200 steps) and the 100m one (30 steps) in checkpoint directories of
     their own (finite logged losses, the last below the first).
The sweeps include sweep_batched (kernel 1 over B = 1, 2, 4, 7 stacked
lanes, each lane bitwise its solo call, with one gamma and with a gamma per
lane) and sweep_rows (kernel 2 over row
lists, bitwise the whole-slab call's rows at every width up to 8192).
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
import os
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


def rows_at(L: int) -> int:
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
            check(L, rows_at(L), m, 64, True)
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
        v32, mask32 = candidates(rows_at(L), L)
        for dtype in worst:
            dt = getattr(torch, dtype)
            v, mask = v32.to(device, dt), mask32.to(device, dt)
            for radius in (1.0, 2.5):
                for inequality in (True, False):
                    got = ksp.simplex_proj(v, mask, radius, inequality=inequality)
                    check(got, v, mask, radius, inequality, f"L={L}", "cases")
    widths = (1, 2, 4, 8, 16, 32, 64, 512, 8192)
    slabs = [candidates(3000 if L <= 32 else rows_at(L), L) for L in widths]
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


def phase_sweep_batched(device) -> dict:
    """Kernel 1 over the tenant axis: B stacked instances of one shape in one
    call against each lane's solo call (its own plan, the same grid), x, A
    x, c'x and ||x||^2 bitwise, at B = 1, 2, 4, 7, fp32 and bf16, lanes with
    coefficients of different magnitudes (so their fixed-point shifts
    differ), a whole call of widths 1-32 with a bucket of 64, both sides of
    the shared-memory histogram's capacity; then the launches of one
    batched call: one narrow launch (one more per bucket wider than 32) and
    one finalize, whatever B.  Each B and dtype also runs with a distinct
    gamma per lane (the batched PDHG prox step's 1/gamma table), every lane
    bitwise its solo call at its own gamma."""
    import numpy as np
    import torch

    from repro_torch.instances.buckets import Bucket
    from repro_torch.kernels import dual_oracle as kdo

    rng = np.random.default_rng(11)
    counts = {"cases": 0, "lanes": 0, "lanes_bitwise": 0, "lanes_gamma_per_lane": 0,
              "lanes_gamma_per_lane_bitwise": 0}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    bad, shifts_seen, launches = [], set(), []

    def stacked(shapes, B, m, J, dtype):
        lanes = []
        for b in range(B):
            bucket = []
            for n, L in shapes:
                bb, _ = random_bucket(rng, n, L, m, J, dtype, device, 3)
                scale = 4.0 ** (b - 2)  # lane magnitudes differ: shifts differ
                bucket.append(dataclasses.replace(bb, coeff=(bb.coeff.float() * scale)
                                                  .to(bb.coeff.dtype)))
            lanes.append(bucket)
        st = [Bucket(idx=torch.stack([ln[k].idx for ln in lanes]),
                     coeff=torch.stack([ln[k].coeff for ln in lanes]),
                     cost=torch.stack([ln[k].cost for ln in lanes]),
                     mask=torch.stack([ln[k].mask for ln in lanes]), length=shapes[k][1])
              for k in range(len(shapes))]
        return lanes, st

    def check(shapes, B, m, J, dtype, gamma, tag):
        lanes, st = stacked(shapes, B, m, J, dtype)
        lam = torch.from_numpy(rng.random((B, m * J)).astype(np.float32)).to(device)
        plan = kdo.plan_batched(st, J)
        per_lane = isinstance(gamma, list)
        kdo.launches = kdo.finalize_launches = 0
        xs, ax, lin, sq = kdo.oracle_call(
            plan, lam, torch.tensor(gamma, dtype=torch.float32) if per_lane else gamma)
        launches.append({"tag": tag, "B": B, "oracle": kdo.launches,
                         "finalize": kdo.finalize_launches,
                         "wide_buckets": sum(L > 32 for _, L in shapes)})
        for b in range(B):
            solo = kdo.plan_slabs("dual_oracle", lanes[b], J)
            sx, sax, slin, ssq = kdo.oracle_call(solo, lam[b].contiguous(),
                                                 gamma[b] if per_lane else gamma)
            torch.cuda.synchronize()
            shifts_seen.add(solo.shift)
            same = (solo.shift == plan.lane_shifts[b]
                    and all(torch.equal(x[b], y) for x, y in zip(xs, sx))
                    and torch.equal(ax[b], sax) and torch.equal(lin[b], slin)
                    and torch.equal(sq[b], ssq))
            err = max([float((x[b].float() - y.float()).abs().max()) if y.numel() else 0.0
                       for x, y in zip(xs, sx)]
                      + [float((ax[b] - sax).abs().max())])
            worst[dtype] = max(worst[dtype], err)
            counts["lanes"] += 1
            counts["lanes_bitwise"] += int(same)
            counts["lanes_gamma_per_lane"] += int(per_lane)
            counts["lanes_gamma_per_lane_bitwise"] += int(per_lane and same)
            if not same:
                bad.append(f"{tag} {dtype} B={B} lane {b}: max error {err}")
        counts["cases"] += 1
        return plan

    whole = [(300 + 17 * L, L) for L in (1, 2, 4, 8, 16, 32)]
    boundary = []
    for B in (1, 2, 4, 7):
        for dtype in ("float32", "bfloat16"):
            check(whole, B, 1, 64, dtype, 0.5, "whole call")
            check(whole + [(40, 64)], B, 2, 64, dtype, 0.05, "whole call + wide")
            check(whole + [(40, 64)], B, 1, 64, dtype,
                  [float(np.float32(0.013 * 3.7 ** b)) for b in range(B)],
                  "whole call + wide, a gamma per lane")
            for J in (29_000, 29_100):
                plan = check([(2000, 8)], B, 1, J, dtype, 1.0, f"L=8 J={J}")
                if B == 2 and dtype == "float32":
                    lay = plan.launches[0].layout
                    boundary.append({"J": J, "hist": ["smem", "global"][lay.hist_mode]})
    if {row["hist"] for row in boundary} != {"smem", "global"}:
        fail(f"batched sweep missed a side of the capacity boundary: {boundary}")
    if len(shifts_seen) < 2:
        fail("batched sweep lanes all had one fixed-point shift")
    per_call = all(r["oracle"] == 1 + r["wide_buckets"] and r["finalize"] == 1
                   for r in launches)
    out = {"phase": "sweep_batched", **counts, "worst_abs_err": worst,
           "shifts_seen": sorted(shifts_seen), "capacity_boundary": boundary,
           "launches_per_call_ok": per_call,
           "launches_sample": launches[:4]}
    emit(out)
    if bad:
        fail(f"{len(bad)} batched lanes differ from their solo calls: {bad[:6]}")
    if not per_call:
        fail(f"a batched call made other launches than one per width class: {launches}")
    return out


def phase_sweep_rows(device) -> dict:
    """Kernel 2 over a list of requested rows against the full-slab call's
    rows: every power-of-two width up to 8192, fp32 and bf16 slabs, rows
    repeated, q = 1, rows at the slab's end and an empty request; x bitwise
    (fp32 slabs: the full kernel call's rows and the plain step's; bf16: the
    plain step over the widened slab, which is what the direct projection
    returns, and the full call's bf16 rows after the storage cast), mask
    and idx the gathered slab's; one launch for a whole request of widths
    1-32."""
    import numpy as np
    import torch

    from repro_torch.kernels import dual_primal as kdp
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(12)
    counts = {"cases": 0, "bitwise": 0}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    bad, launches = [], []
    J = 64

    def requests_for(buckets):
        reqs = []
        for t, b in enumerate(buckets):
            n = b.cost.shape[0]
            r = rng.integers(0, n, size=min(n, 7))
            reqs.append((t, np.concatenate([r, r[:2], [n - 1, n - 1]]).astype(np.int64)))
        reqs.append((0, np.asarray([buckets[0].cost.shape[0] - 1], np.int64)))  # q = 1
        reqs.append((len(buckets) - 1, np.zeros(0, np.int64)))  # an empty request
        return reqs

    def check(buckets, lam, gamma, dtype, tag):
        plan = kdp.plan_rows(buckets, J)
        reqs = requests_for(buckets)
        kdp.launches = 0
        got = kdp.rows_call(plan, lam, gamma, reqs)
        widths = [buckets[t].cost.shape[-1] for t, r in reqs if r.size]
        launches.append({"tag": tag, "launches": kdp.launches,
                         "expected": int(any(L <= 32 for L in widths))
                         + sum(L > 32 for L in widths)})
        full = kops.fused_dual_primal_call(buckets, lam, gamma, num_destinations=J)
        # the direct projection: the plain step over each whole slab widened
        # to fp32 (on the card a wide row's scan order depends on the slab's
        # row count, which the row-list kernel keeps)
        direct = [kref.dual_primal_ref(b.idx, b.coeff.float(), b.cost.float(), b.mask.float(),
                                       lam, gamma, J) for b in buckets]
        torch.cuda.synchronize()
        for (t, r), (x, mask, idx) in zip(reqs, got):
            rr = torch.from_numpy(r).to(device)
            b = buckets[t]
            px = direct[t][rr]
            ok = (torch.equal(x, px) and torch.equal(mask, b.mask.float()[rr])
                  and torch.equal(idx, b.idx[rr]) and torch.equal(x.to(full[t].dtype), full[t][rr]))
            err = float((x - px).abs().max()) if x.numel() else 0.0
            worst[dtype] = max(worst[dtype], err)
            counts["cases"] += 1
            counts["bitwise"] += int(ok)
            if not ok:
                bad.append(f"{tag} {dtype} bucket {t} q={r.size}: max error {err}")

    for dtype in ("float32", "bfloat16"):
        for L in [1 << k for k in range(14)]:
            b, lam = random_bucket(rng, rows_at(L), L, 1, J, dtype, device, 3)
            for gamma in (0.01, 1.0):
                check([b], lam, gamma, dtype, f"L={L}")
        buckets = [random_bucket(rng, 300 + 17 * L, L, 2, J, dtype, device, 3)[0]
                   for L in (1, 2, 4, 8, 16, 32)]
        lam = torch.from_numpy(rng.random(2 * J).astype(np.float32)).to(device)
        check(buckets, lam, 0.1, dtype, "whole request")
    one_launch = all(r["launches"] == r["expected"] for r in launches)
    out = {"phase": "sweep_rows", **counts, "worst_abs_err": worst,
           "one_launch_per_width_class": one_launch,
           "whole_request_launches": [r["launches"] for r in launches if r["tag"] == "whole request"]}
    emit(out)
    if bad:
        fail(f"{len(bad)} row-list cases differ: {bad[:6]}")
    if not one_launch:
        fail(f"a row-list call made other launches than one per width class: {launches}")
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
    torch.cuda.synchronize()
    allocated0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r = solve.run(args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
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
        "peak_memory_bytes": peak, "peak_memory_delta_bytes": peak - allocated0,
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


def span_seconds(events, names=("ingest", "dispatch", "solve_fence", "absorb")) -> list:
    """Per `cadence` span of a tracer's events: the seconds of each named
    child span inside it (host clock)."""
    cads = sorted((e for e in events if e["name"] == "cadence"), key=lambda e: e["ts"])
    out = []
    for c in cads:
        lo, hi = c["ts"], c["ts"] + c["dur"]
        row = {"cadence_s": c["dur"] / 1e6}
        for n in names:
            row[f"{n}_s"] = sum(e["dur"] for e in events
                                if e["name"] == n and lo <= e["ts"] <= hi) / 1e6
        out.append(row)
    return out


def phase_service_path(sources: int) -> dict:
    """`python -m repro_torch.launch.service` in process at the main path's
    instance: 4 tenants sharing one topology, 1M sources x 10k destinations,
    degree 8, one family, fp32; `--fused-oracle --iters-per-stage 100`, three
    cadences (cold, then two of the reference's random deltas: 2% updates, 3
    inserts, 3 deletes, rhs +-2%) solved as ONE batched group each;
    `--verify` (warm vs cold rel g < 1e-3 with fewer iterations, batched vs
    sequential rel g < 1e-3); a checkpoint under build/ after each cadence and
    a `--resume` run whose first solve is warm.  Held: every oracle launch
    of the run is one batched call's (launches == finalizes == batched
    fused calculate calls, every bucket L <= 32).  Then, on the tenants'
    resident instances: a warm fixed-budget stage (gamma 0.1, 100
    iterations, each lane's sigma^2) as one batched solve and as 4 solo
    solves, ms per iteration and each lane's lam rel-L2 between them; the
    batched oracle call at B = 4 against each lane's solo call (bitwise) and
    against its HBM bound; and the per-cadence ingest, dispatch (grouping and
    scatter-plan replays), solve and absorb seconds from the spans."""
    import shutil

    import torch

    from repro_torch import telemetry
    from repro_torch.core import MaximizerConfig
    from repro_torch.core import batched as cb
    from repro_torch.kernels import dual_oracle as kdo
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import service
    from repro_torch.service import (
        BatchedSolvePool, compiled_solver_fixed_sigma, stack_instances, to_solve_result,
    )

    ckpt = ROOT / "build" / "chip_smoke" / "service_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    common = ["--sources", str(sources), "--destinations", "10000", "--avg-degree", "8",
              "--families", "1", "--tenants", "4", "--iters-per-stage", "100",
              "--fused-oracle", "--checkpoint-dir", str(ckpt), "--device", "cuda"]
    calls = {"n": 0}
    calculate = cb.BatchedObjective.calculate

    def counted(self, lam, gamma):
        calls["n"] += int(self.fused_oracle)
        return calculate(self, lam, gamma)

    telemetry.set_registry(telemetry.MetricsRegistry())
    telemetry.set_tracer(telemetry.Tracer())
    cb.BatchedObjective.calculate = counted
    try:
        reset_counts()
        t0 = time.perf_counter()
        run = service.run(service.build_parser().parse_args(
            common + ["--cadences", "3", "--verify"]))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        fused_calls = calls["n"]
        per_cadence = span_seconds(telemetry.get_tracer().events())
        reset_counts()
        calls["n"] = 0
        resumed = service.run(service.build_parser().parse_args(
            common + ["--cadences", "1", "--resume"]))
        resume_counts, resume_calls = read_counts(), calls["n"]
    finally:
        cb.BatchedObjective.calculate = calculate
    if run.code != 0 or not run.verify["ok"]:
        fail(f"service CLI --verify failed: {run.verify}")
    reports = [out.reports for _, out, _ in run.cadences]
    first = resumed.cadences[0][1]
    if resumed.resumed_from != 2 or not all(r["mode"] == "warm" for r in first.reports.values()):
        fail(f"the resumed run's first solve is not warm: {resumed.resumed_from}, "
             f"{[r['mode'] for r in first.reports.values()]}")
    groups = [out.batched_groups for _, out, _ in run.cadences + resumed.cadences]
    if not all(len(g) == 1 and len(g[0]) == 4 for g in groups):
        fail(f"the 4 tenants were not one batched group every cadence: {groups}")
    if not (counts["dual_oracle"] == counts["dual_oracle_finalize"] == fused_calls > 0
            and resume_counts["dual_oracle"] == resume_calls > 0
            and counts["dual_primal"] == counts["simplex_proj"] == 0):
        fail(f"oracle launches {counts} / {resume_counts} against batched fused calculate "
             f"calls {fused_calls} / {resume_calls}")

    # batched against solo on the card: one warm fixed-budget stage
    sched = run.scheduler
    names = sorted(sched.sessions)
    insts = [sched.sessions[n].device_instance() for n in names]
    lam0s = [sched.sessions[n].lam_prev for n in names]
    sigmas = [sched.sessions[n]._sigma_sq for n in names]
    cfg = MaximizerConfig(gammas=(0.1,), iters_per_stage=100)
    pool = BatchedSolvePool(cfg, normalize=True, fused_oracle=True)

    def clock(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        v = fn()
        torch.cuda.synchronize()
        return v, time.perf_counter() - t

    pool.solve(insts, lam0s, sigmas)  # first call: plans
    batch, batch_s = clock(lambda: pool.solve(insts, lam0s, sigmas))
    solo_fn = compiled_solver_fixed_sigma(cfg, normalize=True, fused_oracle=True)
    sig_t = [torch.tensor(s, dtype=torch.float32, device="cuda") for s in sigmas]
    solo, solo_s = clock(lambda: [to_solve_result(solo_fn(i, l, g))
                                  for i, l, g in zip(insts, lam0s, sig_t)])
    lane_rel = [rel_l2(b.lam, s.lam) for b, s in zip(batch, solo)]
    lane_g = [rel_diff(b.g, s.g) for b, s in zip(batch, solo)]
    if max(lane_g) > 1e-3:
        fail(f"batched vs solo warm stage: rel g {lane_g}")

    # the batched oracle call at B = 4: bitwise each lane's solo call, timed
    stacked = cb.normalize_lanes(stack_instances(insts))
    obj = cb.BatchedObjective(stacked, fused_oracle=True)
    plan = obj.kernel_plan()
    lam = torch.stack([b.lam for b in batch]).contiguous()
    J, m = stacked.num_destinations, stacked.num_families
    xs, ax, lin, sq = kdo.oracle_call(plan, lam, 0.1)
    exact = True
    for b, o in enumerate(obj.lanes):
        sp = o.kernel_plan("dual_oracle")
        sx, sax, slin, ssq = kdo.oracle_call(sp, lam[b].contiguous(), 0.1)
        exact &= (sp.shift == plan.lane_shifts[b] and torch.equal(ax[b], sax)
                  and torch.equal(lin[b], slin) and torch.equal(sq[b], ssq)
                  and all(torch.equal(x[b], y) for x, y in zip(xs, sx)))
    torch.cuda.synchronize()
    if not exact:
        fail("the batched oracle call at the service path's shapes differs from the solo calls")
    B = len(insts)
    slots = sum(bk.idx[0].numel() for bk in stacked.buckets)
    call_bytes = B * (slots * kops.oracle_slab_slot_bytes(m, stacked.slab_dtype)
                      + 4 * m * J * 2 + 8)
    ops = B * sum(slab_ops(o, m) for o in obj.lanes[0].instance.buckets)
    solo_plan = obj.lanes[0].kernel_plan("dual_oracle")
    batched_call = {
        "B": B, "launches_per_call": len(plan.launches), "lane_shifts": list(plan.lane_shifts),
        "bitwise_each_lane_solo": exact,
        "kernel_ms": event_ms(lambda: kdo.oracle_call(plan, lam, 0.1), 30),
        "device_ms": device_ms(lambda: kdo.oracle_call(plan, lam, 0.1), 10,
                               r"oracle_(narrow|wide|finalize)"),
        "solo_call_ms_x4": 4 * event_ms(lambda: kdo.oracle_call(
            solo_plan, lam[0].contiguous(), 0.1), 30),
        "plain_ms": event_ms(lambda: kref.dual_oracle_batched_ref(stacked.buckets, lam, 0.1, J),
                             3, warmup=1),
        "bytes": call_bytes, "fp32_ops": ops, **bound_of(call_bytes, ops),
    }
    out = {
        "phase": "service_path", "sources": sources, "tenants": B, "run_s": run_s,
        "verify": run.verify, "resumed_from": resumed.resumed_from,
        "resumed_modes": sorted({r["mode"] for r in first.reports.values()}),
        "batched_groups": groups, "launch_counts": counts,
        "batched_fused_calculate_calls": fused_calls,
        "resume_launch_counts": resume_counts, "resume_batched_fused_calculate_calls": resume_calls,
        "iters_used": [[r[n]["iters_used"] for n in names] for r in reports],
        "upload": [[r[n]["upload_mode"] for n in names] for r in reports],
        "per_cadence_s": per_cadence,
        "warm_stage": {"iterations": cfg.iters_per_stage, "batched_s": batch_s,
                       "solo_x4_s": solo_s,
                       "batched_ms_per_iter": batch_s / cfg.iters_per_stage * 1e3,
                       "solo_x4_ms_per_iter": solo_s / cfg.iters_per_stage * 1e3,
                       "lane_rel_l2_lam_batched_vs_solo": lane_rel,
                       "lane_rel_g_batched_vs_solo": lane_g},
        "batched_call": batched_call,
        "profile": profile_window(lambda: cb._run(cb._agd_body(
            obj.calculate, 0.1, torch.full((B,), 1e-3, device="cuda"), acceleration=True,
            adaptive_restart=True), cb._init_carry(lam), 20), "service_batched", 20),
    }
    emit(out)
    return {"launches": counts["dual_oracle"] + resume_counts["dual_oracle"],
            "finalizes": counts["dual_oracle_finalize"] + resume_counts["dual_oracle_finalize"],
            "batched_call": batched_call, "out": out}


def phase_service_pdhg_path(sources: int) -> dict:
    """`python -m repro_torch.launch.service --engine pdhg --fused-oracle
    --tenants 4` in process at the main path's instance (1M sources x 10k
    destinations, degree 8, one family, fp32; `--iters-per-stage 100`), a
    cold and a warm cadence, each ONE batched PDHG solve of the 4 tenants.
    Held: every oracle launch and finalize of the run is one batched prox
    step's (1 narrow launch + 1 finalize per batched PDHG iteration, no solo
    step); each lane's y, iteration count and restart count against its
    solo PDHG solve of the same cadence's inputs (bitwise y expected).
    Then, on the last cadence's stacked lanes: the batched prox step's
    device time against its bound and against 4 solo steps, a batched
    PDHG iteration against 4 solo ones (host clock), a check's residuals
    over the 4 lanes, and a profiled window of batched iterations."""
    import torch

    from repro_torch import telemetry
    from repro_torch.core.batched import BatchedObjective, lane_instance
    from repro_torch.engines import pdhg as epdhg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import service
    from repro_torch.service import engine as seng

    common = ["--sources", str(sources), "--destinations", "10000", "--avg-degree", "8",
              "--families", "1", "--tenants", "4", "--iters-per-stage", "100",
              "--engine", "pdhg", "--fused-oracle", "--device", "cuda"]
    calls, solves = {"batched": 0, "solo": 0}, []
    batched_call, solo_call = kops.fused_pdhg_step_batched_call, kops.fused_pdhg_step_call
    batched_solve = seng._BATCHED["pdhg"]

    def count_batched(*a, **k):
        calls["batched"] += 1
        return batched_call(*a, **k)

    def count_solo(*a, **k):
        calls["solo"] += 1
        return solo_call(*a, **k)

    def recorded(stacked, lam0, cfg, normalize, fused, sigma_sq=None):
        raw = batched_solve(stacked, lam0, cfg, normalize, fused, sigma_sq)
        solves.append((stacked, lam0, cfg, normalize, fused, sigma_sq, raw))
        return raw

    telemetry.set_registry(telemetry.MetricsRegistry())
    telemetry.set_tracer(telemetry.Tracer())
    kops.fused_pdhg_step_batched_call, kops.fused_pdhg_step_call = count_batched, count_solo
    seng._BATCHED["pdhg"] = recorded
    try:
        reset_counts()
        t0 = time.perf_counter()
        run = service.run(service.build_parser().parse_args(common + ["--cadences", "2"]))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        step_calls = dict(calls)
        per_cadence = span_seconds(telemetry.get_tracer().events())
    finally:
        kops.fused_pdhg_step_batched_call, kops.fused_pdhg_step_call = batched_call, solo_call
        seng._BATCHED["pdhg"] = batched_solve
    if run.code != 0:
        fail(f"service CLI --engine pdhg exited {run.code}")
    groups = [out.batched_groups for _, out, _ in run.cadences]
    engines = sorted({r["engine"] for _, out, _ in run.cadences for r in out.reports.values()})
    if not (all(len(g) == 1 and len(g[0]) == 4 for g in groups) and engines == ["pdhg"]
            and len(solves) == 2):
        fail(f"the 4 tenants were not one batched pdhg group every cadence: {groups}, "
             f"engines {engines}, {len(solves)} batched solves")
    iters_run = [int(raw.iters.max()) for *_, raw in solves]
    if not (counts["dual_oracle"] == counts["dual_oracle_finalize"] == step_calls["batched"]
            == sum(iters_run) > 0 and step_calls["solo"] == 0
            and counts["dual_primal"] == counts["simplex_proj"] == counts["width_routed"] == 0):
        fail(f"service pdhg launches {counts}, batched steps {step_calls}, batched "
             f"iterations {iters_run}: expected 1 narrow launch + 1 finalize each")

    # each lane against its solo PDHG solve of the same cadence
    lanes = []
    for k, (stacked, lam0, cfg, normalize, fused, sigma_sq, raw) in enumerate(solves):
        for b in range(lam0.shape[0]):
            solo = epdhg.pdhg_raw_solve(lane_instance(stacked, b), lam0[b], cfg, normalize,
                                        fused, None if sigma_sq is None else sigma_sq[b])
            lanes.append({
                "cadence": k, "lane": b, "iters": int(raw.iters[b, 0]),
                "solo_iters": int(solo.iters[0]), "restarts": int(raw.restarts[b]),
                "solo_restarts": int(solo.restarts),
                "y_bitwise": bool(torch.equal(raw.lam[b], solo.lam)),
                "y_rel_l2": rel_l2(raw.lam[b], solo.lam),
                "rel_g": rel_diff(raw.g[b], solo.g),
                "sigma_given": sigma_sq is not None})
    bad = [ln for ln in lanes if ln["iters"] != ln["solo_iters"]
           or ln["restarts"] != ln["solo_restarts"] or ln["y_rel_l2"] > 1e-5]

    # the batched prox step and a batched iteration on the last cadence's lanes
    stacked, lam0, cfg, normalize, fused, sigma_sq, raw = solves[-1]
    from repro_torch.core.batched import normalize_lanes

    norm = normalize_lanes(stacked)
    obj = BatchedObjective(norm)
    sig = raw.sigma_sq
    core = epdhg.PDHGBatchedCore(obj, raw.lam, cfg, epdhg.PDHGEngineConfig(),
                                 fused_oracle=True, sigma_sq=sig)
    B = core.B
    state = core.initial_state()
    step = core.step
    y = raw.lam.contiguous()
    xs = state.x
    m, J = norm.num_families, norm.num_destinations
    slots = sum(b.idx[0].numel() for b in norm.buckets)
    byts = B * (slots * (4 * (m + 4) + 4) + 4 * m * J * 2)
    ops = B * (sum(slab_ops(b, m) for b in obj.lanes[0].instance.buckets) + 2 * slots)
    call = lambda: kops.fused_pdhg_step_batched_call(step, xs, y)  # noqa: E731
    c0 = read_counts()
    before = c0["dual_oracle"], c0["dual_oracle_finalize"]
    got_xs, got_ax = call()
    after = read_counts()
    per_step = (after["dual_oracle"] - before[0], after["dual_oracle_finalize"] - before[1])
    solo_cores = [epdhg.PDHGCore(o, raw.lam[b], cfg, epdhg.PDHGEngineConfig(), fused_oracle=True,
                                 sigma_sq=sig[b]) for b, o in enumerate(obj.lanes)]
    solo_steps = [c.step for c in solo_cores]
    exact = True
    for b, (c, st) in enumerate(zip(solo_cores, solo_steps)):
        sx, sax = kops.fused_pdhg_step_call(st, [x[b] for x in xs], y[b].contiguous(), c.tau)
        exact &= (torch.equal(got_ax[b], sax)
                  and all(torch.equal(x[b], t) for x, t in zip(got_xs, sx)))
    torch.cuda.synchronize()

    def solo4():
        for b, (c, st) in enumerate(zip(solo_cores, solo_steps)):
            kops.fused_pdhg_step_call(st, [x[b] for x in xs], y[b], c.tau)

    def plain():
        costs = [torch.sub(cb, torch.mul(x, step.inv_tau)) for cb, x in zip(step.costs, xs)]
        slabs = [dataclasses.replace(sl, cost=cc) for sl, cc in zip(step.slabs, costs)]
        return kref.dual_oracle_batched_ref(slabs, y, step.inv_tau.view(-1), J)

    def clock(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def iterate(c, st0, n):
        s = st0
        for _ in range(n):
            s = c.one_iter(s)
        return s

    solo_states = [c.initial_state() for c in solo_cores]
    batched_iter_ms = clock(lambda: iterate(core, state, 25), 2) / 25
    solo_iter_ms = sum(clock(lambda c=c, s0=s0: iterate(c, s0, 25), 2) / 25
                       for c, s0 in zip(solo_cores, solo_states))
    batched_check_ms = clock(lambda: core._check(state), 2)
    solo_check_ms = sum(clock(lambda c=c, s0=s0: c._check(s0), 2)
                        for c, s0 in zip(solo_cores, solo_states))
    step_out = {
        "B": B, "slots_per_lane": slots, "oracle_launches_per_step": per_step[0],
        "finalize_launches_per_step": per_step[1],
        "bitwise_each_lane_solo_step": exact,
        "kernel_ms": event_ms(call, 30),
        "device_ms": device_events(call, 10)[0],
        "oracle_device_ms": device_ms(call, 10, r"oracle_(narrow|wide|finalize)"),
        "cost_eff_write_device_ms": device_events(lambda: step.write_cost_eff(xs), 10)[0],
        "solo_steps_x4_ms": event_ms(solo4, 20),
        "solo_steps_x4_device_ms": device_events(solo4, 10)[0],
        "plain_ms": event_ms(plain, 3, warmup=1),
        "bytes": byts, "fp32_ops": ops, **bound_of(byts, ops), "library_ms": None,
    }
    out = {
        "phase": "service_pdhg_path", "sources": sources, "tenants": B, "run_s": run_s,
        "batched_groups": groups, "engines": engines, "launch_counts": counts,
        "batched_step_calls": step_calls["batched"], "solo_step_calls": step_calls["solo"],
        "batched_iterations_per_cadence": iters_run,
        "launches_per_batched_iteration": {
            "oracle": counts["dual_oracle"] / max(1, step_calls["batched"]),
            "finalize": counts["dual_oracle_finalize"] / max(1, step_calls["batched"])},
        "per_cadence_s": per_cadence, "lanes_vs_solo": lanes,
        "lanes_y_bitwise": sum(ln["y_bitwise"] for ln in lanes),
        "batched_step": step_out,
        "iteration_ms": {"batched": batched_iter_ms, "solo_x4": solo_iter_ms},
        "check_ms": {"batched": batched_check_ms, "solo_x4": solo_check_ms,
                     "residuals_batched": batched_check_ms - 25 * batched_iter_ms,
                     "residuals_solo_x4": solo_check_ms - 25 * solo_iter_ms},
        "profile": profile_window(lambda: iterate(core, state, 20), "service_pdhg", 20),
    }
    emit(out)
    if bad:
        fail(f"{len(bad)} batched pdhg lanes part from their solo solves: {bad}")
    if per_step != (1, 1) or not exact:
        fail(f"the batched prox step: launches {per_step}, bitwise each lane {exact}")
    if not all(math.isfinite(float(v)) for v in raw.g):
        fail(f"non-finite batched pdhg objective {raw.g}")
    return {"launches": counts["dual_oracle"], "finalizes": counts["dual_oracle_finalize"],
            "batched_step": step_out, "out": out}


def phase_dryrun(main, times) -> dict:
    """The port's solver dry run (`repro_torch.launch.dryrun`) of the main
    path's own instance (its slabs seen as meta-device tensors): its bytes
    per fused-oracle call against the kernel table's bound bytes (equal),
    its grid against the plan's, and its per-shard memory estimate against
    the main path's measured `torch.cuda.max_memory_allocated()`; then the
    `s100M-d10K` cells at shards 1 and 4 with whether each fits."""
    import torch

    from repro_torch.launch import dryrun

    r = main["run"]
    inst = r.instance
    meta = dataclasses.replace(inst, buckets=tuple(
        dataclasses.replace(b, **{k: torch.empty_like(getattr(b, k), device="meta")
                                  for k in ("idx", "coeff", "cost", "mask")})
        for b in inst.buckets), rhs=torch.empty_like(inst.rhs, device="meta"), pack_info=None)
    rec = dryrun.solver_cell(meta, "main-path", 1, fused_oracle=True,
                             iters=r.config.iters_per_stage)
    plan = r.objective.kernel_plan("dual_oracle")
    bound_bytes = times["call"]["bytes"]
    peak = main["summary"]["peak_memory_bytes"]
    cells = [dryrun.run_solver_cell("s100M-d10K", s, fused_oracle=True) for s in (1, 4)]
    out = {
        "phase": "dryrun", "main_path": {
            "oracle_call_bytes": rec["oracle_call"]["bytes"],
            "kernel_table_bound_bytes": bound_bytes,
            "equal": rec["oracle_call"]["bytes"] == bound_bytes,
            "grid_estimate": rec["oracle_call"]["grids"],
            "grid_planned": [lp.grid for lp in plan.launches],
            "hist_partial_bytes": rec["oracle_call"]["hist_partial_bytes"],
            "bytes_global_per_stage": rec["bytes_global"], "roofline": rec["roofline"],
            "memory_estimate": rec["memory"],
            "measured_peak_bytes": peak,
            "measured_peak_delta_bytes": main["summary"]["peak_memory_delta_bytes"],
            "estimate_over_measured": rec["memory"]["estimate_bytes"] / peak},
        "s100M-d10K": [{"shards": c["shards"], "memory_gb_per_shard":
                        c["memory"]["estimate_bytes"] / 1e9, "fits": c["memory"]["fits"],
                        "bytes_global": c["bytes_global"], "oracle_call": c["oracle_call"],
                        "collectives": c["collectives"], "roofline": c["roofline"]}
                       for c in cells],
    }
    emit(out)
    if not out["main_path"]["equal"]:
        fail(f"dry run bytes per call {rec['oracle_call']['bytes']} != the bound's {bound_bytes}")
    return out


def phase_serve_path(sources: int) -> dict:
    """`python -m repro_torch.launch.serve` in process: 2 tenants (seeds s,
    s+1) at the main path's size, `--iters-per-stage 50` (cut from the CLI's
    100 to keep the smoke short), a cold cadence, then 3 pipelined cost-only
    cadences (2% of the edges) while 2 hammer threads, each on its own CUDA
    stream, query batches of 128 users; `--verify`: every served batch
    bitwise `direct_allocations` of the generation it reports (0 mismatches
    required), and kernel 2's launches: one per query (plus one per bucket
    wider than 32 a query touches).  Then the row-list call's device time
    per query from the profiler against its bound, its host time, and the
    overlap share of the pipelined cadences."""
    import numpy as np
    import torch

    from repro_torch import telemetry
    from repro_torch.kernels import dual_primal as kdp
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve

    argv = ["--sources", str(sources), "--destinations", "10000", "--avg-degree", "8",
            "--tenants", "2", "--cadences", "3", "--batch", "128", "--hammer-threads", "2",
            "--iters-per-stage", "50", "--verify", "--device", "cuda"]
    telemetry.set_registry(telemetry.MetricsRegistry())
    telemetry.set_tracer(telemetry.Tracer())
    reset_counts()
    run = serve.run(serve.build_parser().parse_args(argv))
    counts = read_counts()
    store = run.store
    expected = 0
    for r in run.results:
        widths = [store.get(r.tenant, r.generation).instance.buckets[ba.bucket].length
                  for ba in r.slabs]
        expected += int(any(L <= 32 for L in widths)) + sum(L > 32 for L in widths)
    # the verify replays call no kernel 2 (the direct projection is unfused)
    if run.failures != 0 or counts["dual_primal"] != expected or not run.results:
        fail(f"serve path: {run.failures} mismatched batches, kernel 2 launches "
             f"{counts['dual_primal']} against {expected} expected for "
             f"{len(run.results)} queries")
    by_tenant = {}
    for r in run.results:
        by_tenant.setdefault(r.tenant, []).append(r)
    lat = {n: {"batches": len(rs),
               "p50_ms": float(np.percentile([r.latency_seconds for r in rs], 50) * 1e3),
               "p99_ms": float(np.percentile([r.latency_seconds for r in rs], 99) * 1e3),
               "generations": sorted({r.generation for r in rs})}
           for n, rs in sorted(by_tenant.items())}
    users = sum(r.num_users for r in run.results)
    reg = telemetry.get_registry()
    overlap_ingest = reg.counter_total("scheduler_overlap_ingest_seconds_total")
    window = reg.counter_total("scheduler_solve_window_seconds_total")

    # one query's row-list call alone: device time against its bound
    snap = store.snapshot("t0")
    live = np.flatnonzero(snap.deg > 0)
    batch = np.random.default_rng(5).choice(live, size=128)
    b_of = snap.bucket_of[batch]
    reqs = [(int(t), snap.row_of[batch[b_of == t]]) for t in np.unique(b_of)]
    route = snap.query_route()
    inst = snap.instance
    call = lambda: kops.fused_dual_primal_rows(  # noqa: E731
        inst.buckets, reqs, snap.lam_eff, snap.gamma, num_destinations=inst.num_destinations,
        plan=route["plan"])
    slots = sum(len(r) * inst.buckets[t].length for t, r in reqs)
    byts = slots * kops.oracle_slab_slot_bytes(1, inst.slab_dtype) + 8 * len(batch) \
        + 4 * inst.num_destinations
    ops = sum(len(r) * inst.buckets[t].length for t, r in reqs) * 40
    query = {
        "q": int(len(batch)), "buckets": len(reqs), "slots": slots,
        "device_ms": device_ms(call, 50, r"rows_(narrow|wide)"),
        "kernel_event_ms": event_ms(call, 50),
        "host_ms": host_ms(call, 200),
        "query_host_ms": host_ms(lambda: store.query_snapshot(snap, batch), 100),
        **bound_of(byts, ops), "bytes": byts,
    }
    out = {
        "phase": "serve_path", "sources": sources, "tenants": 2, "wall_s": run.wall_seconds,
        "contention": hammer_contention(run, batch),
        "batches": len(run.results), "users": users,
        "users_per_s": users / max(run.wall_seconds, 1e-9), "latency": lat,
        "published_generations": [{n: o.reports[n]["published_generation"] for n in o.reports}
                                  for o in run.outs],
        "verify_mismatches": run.failures, "kernel2_launches": counts["dual_primal"],
        "kernel2_launches_expected": expected, "launch_counts": counts,
        "overlap_ingest_s": overlap_ingest, "solve_window_s": window,
        "overlap_share": overlap_ingest / max(window, 1e-9),
        "per_cadence_s": span_seconds(telemetry.get_tracer().events(),
                                      ("dispatch", "overlap_ingest", "solve_fence", "absorb")),
        "query": query,
    }
    emit(out)
    return {"launches": counts["dual_primal"], "query": query, "out": out}


def hammer_contention(run, batch) -> dict:
    """ms per iteration of one warm AGD stage of tenant t0 (its solo solve,
    unfused, as the serve CLI's scheduler runs it; 20 iterations) alone,
    and while two threads query the store back to back on their own
    streams, at three GIL switch intervals: how much the query threads slow
    the solver thread's host loop."""
    import sys
    import threading

    import torch

    from repro_torch.core import MaximizerConfig
    from repro_torch.service import compiled_solver

    store = run.store
    sess = run.scheduler.sessions["t0"]
    inst, lam0 = sess.device_instance(), sess.lam_prev
    iters = 20
    solve = compiled_solver(MaximizerConfig(gammas=(0.1,), iters_per_stage=iters),
                            normalize=True)

    def solve_ms():
        torch.cuda.synchronize()
        t = time.perf_counter()
        solve(inst, lam0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / iters * 1e3

    solve_ms()
    out = {"iterations": iters, "alone_ms_per_iter": solve_ms()}
    switch = sys.getswitchinterval()
    for interval in (5e-3, 2e-4, 2e-5):
        stop, counts = threading.Event(), []

        def hammer():
            stream, n = torch.cuda.Stream(), 0
            with torch.cuda.stream(stream):
                while not stop.is_set():
                    store.query("t0", batch)
                    n += 1
            counts.append(n)

        sys.setswitchinterval(interval)
        threads = [threading.Thread(target=hammer, daemon=True) for _ in range(2)]
        try:
            for t in threads:
                t.start()
            t0 = time.perf_counter()
            ms = solve_ms()
            wall = time.perf_counter() - t0
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
            sys.setswitchinterval(switch)
        out[f"interval_{interval:g}"] = {"ms_per_iter": ms,
                                         "queries_per_s": sum(counts) / max(wall, 1e-9)}
    return out


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


# ---------------------------------------------------------------------------
# The LM substrate's serving path: no kernel of the port (its products are
# torch.matmul / torch.einsum), so each phase also holds that none of the
# three kernels launched.
# ---------------------------------------------------------------------------

LM_TOL = dict(atol=0.05, rtol=0.05)  # the reference's, tests/test_lm_demo.py:66-76
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
LM_DEVICE = "cuda"  # the LM phases' device
# prompt tokens per request of lm_qwen3_8b's engine runs: each is prefilled
# by teacher-forced batch-1 decode steps of ~80 ms at 36 layers (64 tokens
# took ~80 s more of the whole script's time limit)
LM_ENGINE_PROMPT = 16


def lm_release() -> dict:
    """Drop what earlier phases left cached on the card and reset the peak
    statistics; what is still allocated afterwards."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return {"allocated_gb": torch.cuda.memory_allocated() / 1e9}


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def lm_close(got, want, what: str) -> float:
    """Max |got - want|; fails beyond the reference's atol/rtol 0.05."""
    import torch

    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if not (torch.isfinite(g).all() and torch.allclose(g, w, **LM_TOL)):
        fail(f"{what}: max |diff| {err} beyond atol/rtol 0.05 (or not finite)")
    return err


def lm_no_kernel(what: str) -> None:
    counts = read_counts()
    if any(counts.values()):
        fail(f"{what}: the LM path launched a kernel of the port: {counts}")


def lm_prefill_vs_decode(model, params, toks, what: str, *, hold: bool = True,
                         cache_dtype=None) -> dict:
    """`Model.prefill`'s last logits and one decode step after it against
    teacher-forced `decode_step` from an empty cache (the reference's
    tests/test_lm_demo.py:52-77), held at its atol/rtol 0.05 when `hold`;
    the logits ride along under "_logits" for comparisons across dtypes."""
    import torch

    B, S = toks.shape
    logits_pf, cache_pf = model.prefill(params, {"tokens": toks}, max_seq=S + 4)
    cache = model.init_cache(B, S + 4, cache_dtype, device=toks.device)
    for t in range(S):
        lg, cache = model.decode_step(params, toks[:, t:t + 1], t, cache)
    nxt = torch.argmax(lg[:, -1], -1)[:, None]
    lg_a, _ = model.decode_step(params, nxt, S, cache_pf)
    lg_b, _ = model.decode_step(params, nxt, S, cache)
    pairs = {"prefill": (logits_pf[:, -1], lg[:, -1]), "next_step": (lg_a[:, -1], lg_b[:, -1])}
    out = {"batch": B, "prompt": S, "held_at_atol_rtol_0.05": hold}
    for name, (a, b) in pairs.items():
        out[f"{name}_max_abs_err"] = (lm_close(a, b, f"{what}: {name} against decode") if hold
                                      else float((a.float() - b.float()).abs().max()))
    out["logit_scale"] = float(lg[:, -1].float().abs().max())
    out["_logits"] = {"prefill": logits_pf[:, -1].float(), "decode": lg[:, -1].float()}
    return out


def lm_against(pvd: dict, ref: dict) -> dict:
    """Max |diff| of a run's prefill and decode logits against another
    run's of the same params (bf16 against fp32 compute)."""
    return {k: float((pvd["_logits"][k] - ref["_logits"][k]).abs().max())
            for k in ("prefill", "decode")}


def lm_public(d: dict) -> dict:
    return {k: v for k, v in d.items() if not k.startswith("_")}


def lm_engine_run(model, params, prompts, max_new: int, slots: int) -> dict:
    """`ServeEngine` over `prompts`: every request done with `max_new`
    tokens in the vocabulary; the run's wall time and tokens per second."""
    import torch

    from repro_torch.serving.lm_demo import Request, ServeEngine

    eng = ServeEngine(model, params, slots=slots, max_seq=len(prompts[0]) + max_new + 8)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    V = model.cfg.vocab_size
    if not all(r.done and len(r.out_tokens) == max_new and all(0 <= t < V for t in r.out_tokens)
               for r in reqs):
        fail(f"{model.cfg.name}: the engine left a request short or out of the vocabulary")
    return {"tokens": [list(r.out_tokens) for r in reqs], "seconds": secs,
            "tok_per_s": len(reqs) * max_new / secs, "engine": eng}


def lm_decode_bound(cfg, params, cache, B: int, pos: int) -> dict:
    """The least time of one batched decode step: every weight read once
    (the embedding's B gathered rows only, unless tied to the head), the
    cache's valid entries read (attention: positions 0..pos; SSM state and
    conv window read and written), against the H100's HBM rate and its bf16
    peak for 2 operations per weight per token."""
    rest = tree_leaves({k: v for k, v in params.items() if k != "embed"})
    w = sum(x.numel() * x.element_size() for x in rest)
    n = sum(x.numel() for x in rest)
    emb = params["embed"]
    if cfg.tie_embeddings:
        w += emb.numel() * emb.element_size()
        n += emb.numel()
    else:
        w += B * emb.shape[1] * emb.element_size()
    kv = 0
    for name, leaf in cache.items():
        if name in ("h", "conv"):
            kv += 2 * leaf.numel() * leaf.element_size()
        else:
            kv += leaf[:, :, : pos + 1].numel() * leaf.element_size()
    byts, ops = w + kv, 2 * n * B
    b_ms, o_ms = byts / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    return {"bytes": byts, "weight_bytes": w, "cache_bytes": kv, "ops": ops,
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def lm_decode_times(model, params, B: int, max_seq: int, pos: int, tag: str) -> dict:
    """One batched decode step at position `pos` of a `max_seq` cache: its
    time by CUDA events, the host's enqueue time, its bound, and the
    device's busy time per step over a profiled window of steps, with the
    idle share against the profiled window (the profiler's own host cost
    included) and against the unprofiled step time."""
    import torch

    cache = model.init_cache(B, max_seq, device=LM_DEVICE)
    tok = (torch.arange(B, device=LM_DEVICE, dtype=torch.int32) * 11)[:, None]
    step = lambda: model.decode_step(params, tok, pos, cache)
    reps = 10
    out = {"batch": B, "pos": pos, "ms": event_ms(step, reps, warmup=2),
           "host_enqueue_ms": host_ms(step, reps)}
    out.update(lm_decode_bound(model.cfg, params, cache, B, pos))
    prof = profile_window(lambda: [step() for _ in range(reps)], tag, reps)
    out["profile"] = {k: prof[k] for k in ("wall_ms_per_iter", "device_busy_ms_per_iter",
                                           "device_idle_share", "top_device_ms_per_iter")}
    # the profiler slows a host-bound loop; against the unprofiled step time
    busy = prof["device_busy_ms_per_iter"]
    out["device_idle_share"] = 1.0 - busy / out["ms"] if isinstance(busy, float) else busy
    return out


def phase_lm_serve_cli() -> dict:
    """`python -m repro_torch.launch.serve_lm` in process at its defaults
    (reduced qwen3-8b, 8 requests, prompt 16, 24 new tokens, 4 slots), then
    once more with `--arch X` for each of the ten architectures: every
    request done with 24 tokens, all in the vocabulary."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import serve_lm

    lm_release()
    reset_counts()
    runs = {}
    for argv in [[]] + [["--arch", a] for a in ARCH_IDS]:
        run = serve_lm.run(serve_lm.build_parser().parse_args(argv))
        V = run.cfg.vocab_size
        if len(run.requests) != 8 or not all(
                r.done and len(r.out_tokens) == 24 and all(0 <= t < V for t in r.out_tokens)
                for r in run.requests):
            fail(f"serve_lm {argv}: a request short of 24 tokens or out of the vocabulary")
        runs[" ".join(argv) or "defaults"] = {"seconds": run.seconds,
                                              "tok_per_s": run.tokens / run.seconds}
    lm_no_kernel("lm_serve_cli")
    out = {"phase": "lm_serve_cli", "runs": runs}
    emit(out)
    return out


def phase_lm_qwen3_8b() -> dict:
    """qwen3-8b at its published full width and depth (36 layers), random
    fp32 masters from a seeded generator on the card, served in bf16 (cast
    once).  Prefill against teacher-forced decode: at full depth in fp32
    compute, held at the reference's atol/rtol 0.05; in bf16 held on the
    same params cut to 2 layers (the reference test's depth), and measured
    at full depth with both bf16 paths against the fp32 logits.  8 requests
    of 16-token prompts (LM_ENGINE_PROMPT), 32 new tokens each, on 4 slots
    through `ServeEngine`, twice, with identical tokens; the 2-layer cut in fp32
    compute on the card against the CPU; then the times."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    start = lm_release()
    reset_counts()
    cfg = get_config("qwen3-8b")
    model = Model(cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)).to(LM_DEVICE)
    with torch.no_grad():
        t0 = time.perf_counter()
        master = model.init(torch.Generator(device=LM_DEVICE).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pvd32 = lm_prefill_vs_decode(Model(dataclasses.replace(cfg, dtype="float32")), master,
                                     toks, "qwen3-8b fp32", cache_dtype=torch.float32)
        cut = {k: master[k] for k in ("embed", "final_norm", "lm_head")}
        cut["blocks"] = tree_map(lambda x: x[:2].clone(), master["blocks"])
        params = model._lowp(master)
        del master
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated()

        # the same params cut to 2 layers: fp32 compute on the card against
        # the CPU, and bf16 prefill against decode at the reference's depth
        cut32 = Model(dataclasses.replace(cfg, num_layers=2, dtype="float32"))
        small = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32))
        logits = {}
        for dev in (LM_DEVICE, "cpu"):
            p = cut if dev == LM_DEVICE else tree_map(lambda x: x.cpu(), cut)
            lg, c = cut32.prefill(p, {"tokens": small.to(dev)}, max_seq=20)
            lg2, _ = cut32.decode_step(p, small[:, :1].to(dev), 16, c)
            logits[dev] = torch.cat([lg[:, -1], lg2[:, -1]]).cpu()
            del p
        a, b = logits[LM_DEVICE], logits["cpu"]
        cut_err = float((a - b).abs().max())
        cut_rel = float(((a - b).abs() / b.abs().clamp_min(1e-6)).max())
        if not torch.allclose(a, b, rtol=1e-3, atol=1e-5):
            fail(f"qwen3-8b cut to 2 layers, fp32: card against CPU max |diff| {cut_err}")
        cut16 = Model(dataclasses.replace(cfg, num_layers=2))
        pvd_cut = lm_prefill_vs_decode(cut16, cut16._lowp(cut), toks, "qwen3-8b 2 layers bf16")
        del cut
        lm_release()

        pvd16 = lm_prefill_vs_decode(model, params, toks, "qwen3-8b bf16", hold=False)
        prompts = [rng.integers(0, cfg.vocab_size, LM_ENGINE_PROMPT).astype(np.int32)
                   for _ in range(8)]
        runs = [lm_engine_run(model, params, prompts, 32, 4) for _ in range(2)]
        if runs[0]["tokens"] != runs[1]["tokens"]:
            fail("qwen3-8b: two engine runs gave different tokens")
        eng = runs[1].pop("engine")
        runs[0].pop("engine")
        prompt_t = torch.from_numpy(prompts[0]).to(LM_DEVICE)
        engine_prefill_ms = event_ms(lambda: eng._prefill_one(params, prompt_t), 1, warmup=1)
        del eng
        decode = lm_decode_times(model, params, 4, 104, 95, "lm_qwen3_8b_decode")
        toks4 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
                                 ).to(LM_DEVICE)
        prefill_ms = event_ms(lambda: model.prefill(params, {"tokens": toks4}, max_seq=104), 3,
                              warmup=1)
    peak = torch.cuda.max_memory_allocated()
    lm_no_kernel("lm_qwen3_8b")
    out = {
        "phase": "lm_qwen3_8b", "layers": cfg.num_layers, "params": model.param_count(),
        "bf16_param_bytes": tree_nbytes(params), "allocated_before_gb": start["allocated_gb"],
        "init_s": init_s, "init_peak_bytes": init_peak,
        "cut_2_layers_fp32_card_vs_cpu": {"max_abs_err": cut_err, "max_rel_err": cut_rel,
                                          "rtol": 1e-3, "atol": 1e-5},
        "prefill_vs_decode": {"fp32_36_layers": lm_public(pvd32),
                              "bf16_2_layers": lm_public(pvd_cut),
                              "bf16_36_layers": lm_public(pvd16),
                              "bf16_36_layers_against_fp32": lm_against(pvd16, pvd32)},
        "engine": {"requests": 8, "prompt": LM_ENGINE_PROMPT, "max_new": 32, "slots": 4,
                   "runs_s": [r["seconds"] for r in runs],
                   "tok_per_s": [r["tok_per_s"] for r in runs], "tokens_identical": True},
        "decode_step": decode,
        "prefill": {"batch": 4, "prompt": 64, "ms": prefill_ms, "ms_per_token": prefill_ms / 256},
        "engine_prefill_ms_per_token": engine_prefill_ms / LM_ENGINE_PROMPT,
        "serve_peak_bytes": peak,
    }
    emit(out)
    del params
    return out


def phase_lm_deepseek_v2_2l() -> dict:
    """deepseek-v2-236b at its published width cut to 2 layers (one dense MLA
    prefix layer, one MoE layer of 160 experts, top 6, 2 shared), bf16, with
    `router="topk"` and `router="lp"`: prefill against teacher-forced decode
    at the reference's tolerance with a capacity that never binds (capacity
    factor E, so C = T*k: a batch of 64 prefill tokens and one of 2 decode
    tokens drop different assignments at the config's capacity factor by
    design, and the lp router couples a batch's tokens only where capacity
    binds); at the
    config's own capacity factor, prefill and decode steps twice, bit-equal
    (the fixed-order combine); and `lp_route` at its properties
    (tests/test_moe_router.py:58) on the model's router probabilities."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.moe import lp_route

    start = lm_release()
    reset_counts()
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), num_layers=2)
    master = Model(cfg).init(torch.Generator(device=LM_DEVICE).manual_seed(0))
    params = Model(cfg)._lowp(master)
    del master
    lm_release()
    m = cfg.moe
    out = {"phase": "lm_deepseek_v2_2l", "params": Model(cfg).param_count(),
           "bf16_param_bytes": tree_nbytes(params), "allocated_before_gb": start["allocated_gb"]}
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)).to(LM_DEVICE)
    with torch.no_grad():
        for router in ("topk", "lp"):
            rcfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, router=router))
            nodrop = Model(dataclasses.replace(rcfg, moe=dataclasses.replace(
                rcfg.moe, capacity_factor=float(m.num_experts))))
            res = {"prefill_vs_decode_no_drops": lm_public(lm_prefill_vs_decode(
                nodrop, params, toks, f"deepseek-v2 2 layers {router}"))}
            model = Model(rcfg)
            bits = []
            for _ in range(2):
                lg, cache = model.prefill(params, {"tokens": toks}, max_seq=36)
                steps = [lg]
                for t in range(2):
                    lg, cache = model.decode_step(params, torch.argmax(steps[0][:, -1], -1)[:, None],
                                                  32 + t, cache)
                    steps.append(lg)
                bits.append((steps, cache))
            same = all(torch.equal(a, b) for a, b in zip(bits[0][0], bits[1][0])) and all(
                torch.equal(bits[0][1][k], bits[1][1][k]) for k in bits[0][1])
            if not same:
                fail(f"deepseek-v2 2 layers {router}: two runs differ")
            res["two_runs_bit_equal"] = True
            res["decode_step"] = {k: v for k, v in lm_decode_times(
                model, params, 4, 64, 40, f"lm_deepseek_{router}_decode").items()
                if k in ("ms", "host_enqueue_ms", "weight_bytes", "bound_ms", "profile",
                         "device_idle_share")}
            res["decode_step"]["bound_note"] = "all 160 experts' weights (the [E, C] einsum reads them)"
            out[router] = res
        # lp_route on the MoE layer's router at the full width (unit-rms inputs)
        T, E, k = 256, m.num_experts, m.top_k
        x = torch.from_numpy(np.random.default_rng(3).normal(size=(T, cfg.d_model))
                             .astype(np.float32)).to(LM_DEVICE).to(torch.bfloat16)
        w = params["blocks"]["moe"]["router"]["w"][0]
        probs = torch.softmax((x @ w).float(), -1)
        cap = T * k / E * 1.1
        xr = lp_route(probs, k, capacity=cap, iters=64, gamma=0.05)
        props = {"min": float(xr.min()), "max_row_sum": float(xr.sum(1).max()),
                 "max_load": float(xr.sum(0).max()), "capacity": cap}
        if not (props["min"] >= -1e-5 and props["max_row_sum"] <= k + 1e-3
                and props["max_load"] <= cap * 1.25):
            fail(f"lp_route properties: {props}")
        C = int(max(1, round(T * k / E * m.capacity_factor)))
        own = lp_route(probs, k, capacity=C, iters=m.lp_iters, gamma=m.lp_gamma)
        props["model_settings"] = {"C": C, "max_load": float(own.sum(0).max()),
                                   "softmax_max_load": float(probs.sum(0).max() * k)}
        out["lp_route"] = props
    out["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
    lm_no_kernel("lm_deepseek_v2_2l")
    emit(out)
    del params
    return out


def phase_lm_mamba2() -> dict:
    """mamba2-1.3b whole (48 layers): the chunked SSD prefill of 512 tokens
    (two 256-token chunks) against teacher-forced decode at the reference's
    atol/rtol 0.05 in fp32 compute, and in bf16 on the same params cut to 2
    layers; the bf16 prefill at full depth measured against the fp32
    prefill; the bf16 engine over 4 requests of 32-token prompts, 16 new
    tokens each; a decode step's time."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    start = lm_release()
    reset_counts()
    cfg = get_config("mamba2-1.3b")
    model = Model(cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512)).astype(np.int32)).to(LM_DEVICE)
    with torch.no_grad():
        master = model.init(torch.Generator(device=LM_DEVICE).manual_seed(0))
        pvd32 = lm_prefill_vs_decode(Model(dataclasses.replace(cfg, dtype="float32")), master,
                                     toks, "mamba2 fp32", cache_dtype=torch.float32)
        cut16 = Model(dataclasses.replace(cfg, num_layers=2))
        pvd_cut = lm_prefill_vs_decode(cut16, cut16._lowp(
            dict(master, blocks=tree_map(lambda x: x[:2], master["blocks"]))), toks,
            "mamba2 2 layers bf16")
        params = model._lowp(master)
        del master
        lm_release()
        pf16 = model.prefill(params, {"tokens": toks}, max_seq=516)[0][:, -1].float()
        prompts = [rng.integers(0, cfg.vocab_size, 32).astype(np.int32) for _ in range(4)]
        run = lm_engine_run(model, params, prompts, 16, 4)
        run.pop("engine")
        decode = lm_decode_times(model, params, 4, 64, 40, "lm_mamba2_decode")
    lm_no_kernel("lm_mamba2")
    out = {"phase": "lm_mamba2", "layers": cfg.num_layers, "params": model.param_count(),
           "bf16_param_bytes": tree_nbytes(params), "allocated_before_gb": start["allocated_gb"],
           "prefill_vs_decode": {
               "fp32_48_layers": lm_public(pvd32), "bf16_2_layers": lm_public(pvd_cut),
               "bf16_48_layers_prefill_against_fp32": float(
                   (pf16 - pvd32["_logits"]["prefill"]).abs().max())},
           "engine": {"requests": 4, "prompt": 32, "max_new": 16, "slots": 4,
                      "seconds": run["seconds"], "tok_per_s": run["tok_per_s"]},
           "decode_step": decode, "serve_peak_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    del params
    return out


# ---------------------------------------------------------------------------
# The LM substrate's training path: no kernel of the port either (autograd
# over the same matmuls and einsums, eager AdamW).
# ---------------------------------------------------------------------------


class LoopLog:
    """The training loop's log messages (logger "repro_torch.train") while
    attached; `retries` counts its "... retrying" records."""

    def __enter__(self):
        import logging

        self.messages = []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                outer.messages.append(record.getMessage())

        self.handler = Handler()
        self.logger = logging.getLogger("repro_torch.train")
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)

    @property
    def retries(self) -> int:
        return sum("retrying" in m for m in self.messages)


def lm_train_bound(cfg, params, batch: int, seq: int) -> dict:
    """The least time of one train step, as two phases in series: the
    forward and backward's matmul operations (6 per matmul weight per token;
    the embedding gather none) plus attention's (QK^T and PV over the whole
    S x S, as the chunked attention computes them: 4 B S^2 H Dh per layer
    forward, 3x with the backward) at the H100's bf16 peak; then the bytes
    of the fp32 masters' bf16 cast (4 read + 2 written), the grad norm (4
    read) and AdamW (p, g, m, v read, p, m, v written: 28) per parameter at
    its HBM rate."""
    n = sum(x.numel() for x in tree_leaves(params))
    mm = params["lm_head"].numel() + sum(
        x.numel() for x in tree_leaves(params["blocks"]) if x.ndim == 3)
    attn = 3 * 4 * batch * seq * seq * cfg.num_heads * cfg.head_dim * cfg.num_layers
    ops = 6 * mm * batch * seq + attn
    byts = 38 * n
    o_ms, b_ms = ops / BF16_FLOPS * 1e3, byts / HBM_BYTES_PER_S * 1e3
    return {"params": n, "matmul_params": mm, "ops": ops, "attention_ops": attn,
            "bytes": byts, "ops_ms": o_ms, "bytes_ms": b_ms, "bound_ms": o_ms + b_ms,
            "bound_by": "operations, then bytes (two phases in series)"}


def phase_lm_train_qwen3_8b() -> dict:
    """qwen3-8b at its published width (d_model 4096, 32/8 heads, d_ff
    12288, vocab 151,936, qk_norm, untied head, remat, bf16 compute, fp32
    masters) cut in depth to 8 of its 36 layers: at 36 the training state
    (fp32 params, grads and two AdamW moments, 16 B per parameter) is ~131
    GB.  First the card against the CPU: one `value_and_grad(Model.loss)`
    in fp32 on the same params cut to 2 layers, batch 1 x 32: loss and
    global grad norm at rtol 1e-5, named leaves at 1e-4 of each leaf's
    largest |g|.  Then 8 steps through `train_loop` (no checkpoint dir) over
    `SyntheticLMData(batch 8, seq 256, seed 0)` at the full vocabulary with
    the CLI's AdamW: every loss finite, no retry, no kernel of the port;
    host ms per step (each step ending in a synchronize; median of steps
    2-8), tokens/s, peak memory, one profiled step's device busy time and
    idle share, the step's bound, and its parts by CUDA events (forward and
    backward, the bf16 cast, the grad norm, the in-place AdamW)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import Model
    from repro_torch.training import (
        AdamWConfig, TrainLoopConfig, adamw_update_, global_norm, init_train_state,
        make_train_step, train_loop, value_and_grad,
    )
    from repro_torch.training.loop import batch_to_device

    start = lm_release()
    reset_counts()
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=8)
    model = Model(cfg)
    B, S, steps = 8, 256, 8
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=LM_DEVICE).manual_seed(0),
                             device=LM_DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # the card against the CPU: 2 layers of the same params in fp32
    cut32 = Model(dataclasses.replace(cfg, num_layers=2, dtype="float32"))
    small = SyntheticLMData(cfg, batch=1, seq=32, seed=1)(0)
    res = {}
    for dev in (LM_DEVICE, "cpu"):
        p = {k: state.params[k].to(dev) for k in ("embed", "final_norm", "lm_head")}
        p["blocks"] = tree_map(lambda x: x[:2].to(dev), state.params["blocks"])
        loss, grads = value_and_grad(cut32, p, batch_to_device(small, dev))
        res[dev] = {"loss": float(loss), "grad_norm": float(global_norm(grads)),
                    "leaves": {"lm_head": grads["lm_head"].cpu(), "embed": grads["embed"].cpu(),
                               "final_norm": grads["final_norm"].cpu(),
                               "blocks.attn.wq.w": grads["blocks"]["attn"]["wq"]["w"].cpu(),
                               "blocks.mlp.w_down.w": grads["blocks"]["mlp"]["w_down"]["w"].cpu(),
                               "blocks.ln1": grads["blocks"]["ln1"].cpu()}}
        del p, grads
    gpu, cpu = res[LM_DEVICE], res["cpu"]
    cut = {"loss": [gpu["loss"], cpu["loss"]], "grad_norm": [gpu["grad_norm"], cpu["grad_norm"]],
           "loss_rel_err": abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "grad_norm_rel_err": abs(gpu["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"],
           "rtol": 1e-5, "leaf_tol": "1e-4 x max |g| of the leaf", "leaves": {}}
    if not (cut["loss_rel_err"] <= 1e-5 and cut["grad_norm_rel_err"] <= 1e-5):
        fail(f"qwen3-8b 2 layers fp32 train: card against CPU {cut}")
    for name, want in cpu["leaves"].items():
        got = gpu["leaves"][name]
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        cut["leaves"][name] = {"max_abs_err": err, "max_abs": scale}
        if not err <= 1e-4 * scale:
            fail(f"qwen3-8b 2 layers fp32 grad {name}: card against CPU {err} (max |g| {scale})")
    del res, gpu, cpu
    lm_release()

    data = SyntheticLMData(cfg, batch=B, seq=S, seed=0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=max(steps // 10, 1), total_steps=steps)
    losses, marks = [], []

    def on_step(k, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        losses.append(float(metrics["loss"]))

    reset_counts()
    with LoopLog() as loop_log:
        marks.append(time.perf_counter())
        state = train_loop(model, data, opt, TrainLoopConfig(total_steps=steps), state=state,
                           on_step=on_step, device=LM_DEVICE)
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    lm_no_kernel("lm_train_qwen3_8b")
    if loop_log.retries:
        fail(f"lm_train_qwen3_8b: the loop retried {loop_log.retries} step(s)")
    if not (len(losses) == steps and all(math.isfinite(x) for x in losses)):
        fail(f"lm_train_qwen3_8b: losses {losses}")
    if int(state.step) != steps:
        fail(f"lm_train_qwen3_8b: state at step {int(state.step)}")
    peak = torch.cuda.max_memory_allocated()
    median_ms = float(np.median(step_ms[1:]))

    step_fn, _, _ = make_train_step(model, opt)
    batch = batch_to_device(data(steps), LM_DEVICE)
    prof = profile_window(lambda: step_fn(state, batch), "lm_train_qwen3_8b_step", 1)
    bound = lm_train_bound(cfg, state.params, B, S)
    # the step's parts by CUDA events; the AdamW update runs last, on spent
    # grads (it overwrites them as scratch), once the state's checks are done
    parts = {"fwd_bwd_ms": event_ms(lambda: value_and_grad(model, state.params, batch), 2, 1),
             "bf16_cast_ms": event_ms(lambda: model._lowp(state.params), 3, 1)}
    _, grads = value_and_grad(model, state.params, batch)
    parts["grad_norm_ms"] = event_ms(lambda: global_norm(grads), 3, 1)
    parts["adamw_ms"] = event_ms(lambda: adamw_update_(opt, grads, state.opt, state.params), 2, 1)
    del grads
    out = {"phase": "lm_train_qwen3_8b", "layers": cfg.num_layers, "params": model.param_count(),
           "allocated_before_gb": start["allocated_gb"], "init_s": init_s,
           "batch": B, "seq": S, "tokens_per_step": B * S, "steps": steps,
           "cut_2_layers_fp32_card_vs_cpu": cut, "losses": losses, "step_host_ms": step_ms,
           "median_step_ms_2_to_8": median_ms, "tokens_per_s": B * S / median_ms * 1e3,
           "retries": loop_log.retries, "train_peak_bytes": peak,
           "profile": {k: prof[k] for k in ("wall_ms_per_iter", "device_busy_ms_per_iter",
                                            "device_idle_share", "top_device_ms_per_iter")},
           "parts": parts, "bound": bound, "median_over_bound": median_ms / bound["bound_ms"]}
    emit(out)
    del state, step_fn, batch
    return out


def phase_lm_train_cli() -> dict:
    """`python -m repro_torch.launch.train --arch qwen3-8b --reduced` in
    process (batch 8, seq 128): `--steps 30 --save-every 10` uninterrupted;
    then a run stopped after its step-20 save (that checkpoint alone in a
    directory of its own) resumed with the same flags; the two step-30
    checkpoints bit-equal, every array.  The CLI's AdamW schedule spans
    --steps, so a `--steps 20` run is not the first 20 steps of a
    `--steps 30` one; the stop is therefore made at the step-20 save."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.launch import train

    lm_release()
    root = ROOT / "build" / "chip_smoke" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    args = ["--arch", "qwen3-8b", "--reduced", "--steps", "30", "--save-every", "10"]
    reset_counts()
    t0 = time.perf_counter()
    with LoopLog() as loop_log:
        train.main(args + ["--ckpt-dir", str(root / "full")])
        t1 = time.perf_counter()
        shutil.copytree(root / "full" / "step_00000020", root / "stopped" / "step_00000020")
        train.main(args + ["--ckpt-dir", str(root / "stopped")])
        t2 = time.perf_counter()
    lm_no_kernel("lm_train_cli")
    if loop_log.retries:
        fail(f"lm_train_cli: the loop retried {loop_log.retries} step(s)")
    if "resumed from step 20" not in loop_log.messages:
        fail(f"lm_train_cli: the second run did not resume at step 20: {loop_log.messages}")
    if latest_step(str(root / "full")) != 30 or latest_step(str(root / "stopped")) != 30:
        fail("lm_train_cli: a run did not end with its step-30 checkpoint")
    full, _ = CheckpointManager(str(root / "full")).restore_flat(30)
    resumed, _ = CheckpointManager(str(root / "stopped")).restore_flat(30)
    differ = sorted(k for k in full if k not in resumed or not (
        full[k].dtype == resumed[k].dtype and (full[k] == resumed[k]).all()))
    if differ or sorted(full) != sorted(resumed):
        fail(f"lm_train_cli: the resumed run's step-30 state differs from the uninterrupted "
             f"run's in {differ[:5]}")
    losses = [m for m in loop_log.messages if m.startswith("step ")]
    out = {"phase": "lm_train_cli", "argv": args, "uninterrupted_s": t1 - t0,
           "resumed_s": t2 - t1, "arrays": len(full), "bitwise_equal": True,
           "log": losses}
    emit(out)
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# The LM substrate over a mesh: DTensor over a one-rank NCCL group.
# ---------------------------------------------------------------------------


def lm_mesh(shape=(1, 1)):
    """A ("data", "model") mesh over a new one-rank NCCL group on the card
    (path 2 tore its group down; a process has one default group)."""
    from repro_torch.launch import dist as launch_dist
    from repro_torch.launch.mesh import make_mesh

    launch_dist.setup("cuda:0", init_method=f"tcp://localhost:{free_port()}", rank=0,
                      world_size=1)
    return make_mesh(shape, ("data", "model"), "cuda")


def lm_rel(a: list, b: list) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def phase_lm_mesh_train_qwen3_8b() -> dict:
    """The train phase's qwen3-8b cut (full width, 8 of 36 layers, batch 8 x
    256, remat, bf16 compute over fp32 masters): 4 steps of the
    single-device `make_train_step`, then 4 of `make_train_step` over the
    (1, 1) mesh with `default_profile`, then with fsdp forced on, each from
    the seed-0 state and the same batches.  Every run's losses and grad
    norms within 1e-6 relative of the single-device run's (and whether
    bitwise); each step ends in a synchronize; the median host ms of steps
    2-4, the peak memory of each run, one profiled mesh step's idle share;
    no kernel of the port."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import dist as launch_dist
    from repro_torch.launch.mesh import default_profile
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step
    from repro_torch.training.loop import batch_to_device
    from repro_torch.training.train_step import init_sharded_state

    start = lm_release()
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=8)
    model = Model(cfg)
    B, S, steps = 8, 256, 4
    data = SyntheticLMData(cfg, batch=B, seq=S, seed=0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
    gen = lambda: torch.Generator(device=LM_DEVICE).manual_seed(0)

    def run(step, state, tag, profile_it=False):
        losses, norms, ms = [], [], []
        for k in range(steps):
            batch = batch_to_device(data(k), LM_DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            norms.append(norm)
            if k == 0:  # the first step's peak apart from the steady state's
                first_peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
        if not all(math.isfinite(x) for x in losses + norms):
            fail(f"{tag}: losses {losses}, grad norms {norms}")
        out = {"losses": losses, "grad_norms": norms, "step_host_ms": ms,
               "median_step_ms_2_to_4": float(np.median(ms[1:])),
               "peak_bytes_first_step": first_peak,
               "peak_bytes": max(first_peak, torch.cuda.max_memory_allocated()),
               "peak_bytes_steps_2_to_4": torch.cuda.max_memory_allocated()}
        if profile_it:
            batch = batch_to_device(data(steps), LM_DEVICE)
            prof = profile_window(lambda: step(state, batch), tag, 1)
            out["profile"] = {k: prof[k] for k in ("wall_ms_per_iter", "device_busy_ms_per_iter",
                                                   "device_idle_share")}
        return out

    reset_counts()
    step, _, _ = make_train_step(model, opt)
    single = run(step, init_train_state(model, gen(), device=LM_DEVICE), "single")
    del step
    lm_release()
    mesh = lm_mesh()
    runs = {}
    try:
        for name in ("default", "fsdp"):
            profile = default_profile(cfg, mesh)
            if name == "fsdp":
                profile = dataclasses.replace(profile, fsdp=True)
            step, _, _ = make_train_step(model, opt, mesh, profile)
            state = init_sharded_state(model, mesh, profile, gen())
            r = run(step, state, f"lm_mesh_train_{name}", profile_it=name == "default")
            r["profile_used"] = dataclasses.asdict(profile)
            r["loss_rel_err"] = lm_rel(r["losses"], single["losses"])
            r["grad_norm_rel_err"] = lm_rel(r["grad_norms"], single["grad_norms"])
            r["bitwise"] = r["losses"] == single["losses"] and r["grad_norms"] == single["grad_norms"]
            if not (r["loss_rel_err"] <= 1e-6 and r["grad_norm_rel_err"] <= 1e-6):
                fail(f"lm_mesh_train_qwen3_8b {name}: against the single-device step {r}")
            r["median_over_single"] = r["median_step_ms_2_to_4"] / single["median_step_ms_2_to_4"]
            runs[name] = r
            del step, state
            lm_release()
    finally:
        launch_dist.teardown()
    lm_no_kernel("lm_mesh_train_qwen3_8b")
    out = {"phase": "lm_mesh_train_qwen3_8b", "mesh": [1, 1], "layers": cfg.num_layers,
           "params": model.param_count(), "batch": B, "seq": S, "steps": steps,
           "allocated_before_gb": start["allocated_gb"], "single_device": single, "mesh_runs": runs,
           "tolerance": "1e-6 relative"}
    emit(out)
    return out


def phase_lm_mesh_serve_qwen3_8b() -> dict:
    """qwen3-8b at full width and depth (36 layers), fp32 masters from the
    seed-0 generator cast once to bf16: a prefill of 4 prompts of 64 tokens
    and 16 greedy decode steps, first through the single-device
    `Model.prefill` / `decode_step`, then through `make_serve_fns` over the
    (1, 1) mesh (params placed by the rules, the cache by `cache_pspecs`);
    the tokens equal, the logits' largest difference, ms per decode step
    (each step ending in a synchronize; median) of each; no kernel of the
    port."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dist as launch_dist
    from repro_torch.launch.mesh import default_profile
    from repro_torch.models import Model
    from repro_torch.serving.lm_demo import make_serve_fns

    start = lm_release()
    cfg = get_config("qwen3-8b")
    model = Model(cfg)
    B, P, new = 4, 64, 16
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)).to(LM_DEVICE)
    with torch.no_grad():
        params = model._lowp(model.init(torch.Generator(device=LM_DEVICE).manual_seed(0)))
        torch.cuda.synchronize()

        def greedy(prefill, decode, full):
            logits, cache = prefill(params, {"tokens": toks}, P + new)
            out, lg, ms = [], [], []
            for t in range(new):
                nxt = torch.argmax(full(logits)[:, -1], -1).to(torch.int32)[:, None]
                out.append(nxt[:, 0].tolist())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = decode(params, nxt, P + t, cache)
                lg.append(full(logits)[:, -1].float())
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            return {"tokens": out, "logits": torch.stack(lg), "decode_ms": ms,
                    "median_decode_ms": float(np.median(ms[1:]))}

        reset_counts()
        single = greedy(model.prefill, model.decode_step, lambda x: x)
        lm_release()
        mesh = lm_mesh()
        try:
            prefill, decode = make_serve_fns(model, mesh, default_profile(cfg, mesh))
            sharded = greedy(prefill, decode, lambda x: x.full_tensor())
        finally:
            launch_dist.teardown()
    lm_no_kernel("lm_mesh_serve_qwen3_8b")
    if sharded["tokens"] != single["tokens"]:
        fail(f"lm_mesh_serve_qwen3_8b: the mesh's tokens {sharded['tokens']} differ from the "
             f"single device's {single['tokens']}")
    err = float((sharded["logits"] - single["logits"]).abs().max())
    out = {"phase": "lm_mesh_serve_qwen3_8b", "mesh": [1, 1], "layers": cfg.num_layers,
           "batch": B, "prompt": P, "new_tokens": new, "allocated_before_gb": start["allocated_gb"],
           "tokens_equal": True, "logits_max_abs_err": err,
           "logits_bitwise": err == 0.0,
           "single_median_decode_ms": single["median_decode_ms"],
           "mesh_median_decode_ms": sharded["median_decode_ms"],
           "mesh_over_single": sharded["median_decode_ms"] / single["median_decode_ms"],
           "single_decode_ms": single["decode_ms"], "mesh_decode_ms": sharded["decode_ms"],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    del params
    return out


def phase_lm_mesh_dryrun(train: dict) -> dict:
    """The dry run's arch cells in a child process (PyTorch's fake process
    group; no card): qwen3-8b train_4k on the 16 x 16 mesh cut to 4 layers
    (the same ops as the whole model's 36, which took ~40 s more of the
    script's time limit), then the mesh train phase's own cell (8 layers,
    batch 8 x 256, mesh (1, 1)), whose per-card memory estimate is set
    against that phase's measured peak."""
    out_dir = ROOT / "build" / "chip_smoke" / "dryrun"
    cells = {"qwen3-8b/train_4k/single_pod, 4 layers": ["--mesh", "single_pod",
                                                          "--num-layers", "4"],
             "qwen3-8b/train_4k/host1x1 (the mesh train phase)": [
                 "--mesh", "host", "--mesh-shape", "1,1", "--num-layers", "8",
                 "--global-batch", "8", "--seq-len", "256"]}
    recs = {}
    for name, extra in cells.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-8b", "--shape",
             "train_4k", "--out", str(out_dir), *extra],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        if proc.returncode != 0:
            fail(f"lm_mesh_dryrun {name}: exit {proc.returncode}: {proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        tag = "qwen3-8b__train_4k__" + summary["cell"].split("/")[-1]
        rec = json.loads((out_dir / f"{tag}.json").read_text())
        if rec["status"] != "ok":
            fail(f"lm_mesh_dryrun {name}: {rec}")
        recs[name] = {"seconds": time.perf_counter() - t0,
                      **{k: rec[k] for k in ("cell", "chips", "profile", "trace_s", "params",
                                             "model_flops", "flops_global",
                                             "flop_counter_flops_per_device",
                                             "account_bytes_per_device", "collectives",
                                             "coll_bytes_per_device", "memory")}}
    est = recs["qwen3-8b/train_4k/host1x1 (the mesh train phase)"]["memory"]["estimate_bytes"]
    runs = train["mesh_runs"]["default"]
    out = {"phase": "lm_mesh_dryrun", "cells": recs, "host1x1_estimate_bytes": est,
           "mesh_train_peak_bytes": runs["peak_bytes"],
           "estimate_over_peak": est / runs["peak_bytes"],
           "estimate_over_steady_peak": est / runs["peak_bytes_steps_2_to_4"]}
    emit(out)
    return out



# ---------------------------------------------------------------------------
# The examples: the port's `examples/*_torch.py`, each through its main(argv).
# ---------------------------------------------------------------------------

# What the JAX package's examples print on the CPU (examples/quickstart.py,
# lp_moe_routing.py, serve_lm.py at their defaults, JAX_PLATFORMS=cpu).
EXAMPLE_REFERENCE = {
    "quickstart": ["instance: 5000 sources, 200 destinations, 29026 eligible pairs",
                   "buckets: [(1, 70), (2, 250), (4, 1193), (8, 2834), (16, 641), (32, 1)]"],
    "quickstart_g": -5092.7583,
    "top_k_router": "top-k router : max load 3384  imbalance 6.61x  dropped 60.1%",
    "serve_lm_steps": 46,
}
EXAMPLE_RUNS = (
    ("quickstart_torch", []),
    ("production_solve_torch", []),
    ("production_solve_torch", ["--sources", "1000000", "--destinations", "10000"]),
    ("lp_moe_routing_torch", []),
    ("serve_lm_torch", []),
    ("train_lm_torch", ["--ckpt-dir", "{root}/10m"]),
    ("train_lm_torch", ["--preset", "100m", "--steps", "30", "--ckpt-dir", "{root}/100m"]),
)


def load_example(name: str):
    """examples/<name>.py of this checkout as a module (examples/ is not a
    package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def example_number(lines: list, pattern: str, what: str) -> float:
    for ln in lines:
        m = re.search(pattern, ln)
        if m:
            x = float(m.group(1))
            if not math.isfinite(x):
                fail(f"examples {what}: {ln!r} is not finite")
            return x
    fail(f"examples {what}: no line matches {pattern!r} in {lines}")


def check_example(name: str, argv: list, lines: list, log: list) -> dict:
    """The example's printed lines against what the reference prints where
    the card must give the same (the instance, the layout, g at rtol 1e-4,
    the top-k routing, the engine's step count); finite numbers elsewhere.
    The examples' own assertions (production_solve's drift bound, the LP
    router's max load) have run inside main."""
    what = f"{name} {' '.join(argv)}".strip()
    if name == "quickstart_torch":
        if lines[:2] != EXAMPLE_REFERENCE["quickstart"]:
            fail(f"examples {what}: {lines[:2]} against {EXAMPLE_REFERENCE['quickstart']}")
        g = example_number(lines, r"dual objective g = (\S+)", what)
        want = EXAMPLE_REFERENCE["quickstart_g"]
        if not abs(g - want) <= 1e-4 * abs(want):
            fail(f"examples {what}: g = {g} against the reference's {want} (rtol 1e-4)")
        return {"g": g, "max_violation": example_number(lines, r"max violation = (\S+)", what)}
    if name == "production_solve_torch":
        day = [example_number(lines, rf"\[day {d}\] \D*([\d.]+)s", what) for d in (0, 1)]
        if "stability holds" not in lines[-1]:
            fail(f"examples {what}: {lines[-1]!r}")
        iters = 6 * 120  # six gamma stages down to the default floor 0.01, 120 each
        return {"g0": example_number(lines, r"\[day 0\].*g=(\S+)", what),
                "g1": example_number(lines, r"\[day 1\].*g=(\S+)", what),
                "drift": example_number(lines, r"\|\|x1-x0\|\| = (\S+)", what),
                "bound": example_number(lines, r"theoretical bound \S+ (\S+)", what),
                "day_seconds": day, "agd_iters_per_day": iters,
                "ms_per_agd_iter_day1": day[1] / iters * 1e3}
    if name == "lp_moe_routing_torch":
        if lines[1] != EXAMPLE_REFERENCE["top_k_router"]:
            fail(f"examples {what}: {lines[1]!r} against {EXAMPLE_REFERENCE['top_k_router']!r}")
        return {"lp_max_load": example_number(lines, r"LP router +: max load (\d+)", what),
                "loss": example_number(lines, r"loss=(\S+) ", what)}
    if name == "serve_lm_torch":
        steps = example_number(lines, r"in (\d+) engine steps", what)
        if steps != EXAMPLE_REFERENCE["serve_lm_steps"] or len(lines) != 4:
            fail(f"examples {what}: {lines}")
        return {"steps": steps, "tok_per_s": example_number(lines, r"\((\S+) tok/s", what)}
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 200
    losses = [float(m.split()[3]) for m in log if m.startswith("step ")]
    if (f"finished at step {steps};" not in lines[-1] or len(losses) != steps // 10
            or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]):
        fail(f"examples {what}: {lines} {log}")
    return {"losses": losses}


def phase_examples() -> dict:
    """Each port example in process through its `main(argv)` on the card, at
    the reference's defaults: quickstart, production_solve (and again at the
    main path's 1M x 10k), lp_moe_routing, serve_lm, train_lm (10m, 200
    steps; 100m, 30 steps), each train run in a checkpoint directory of its
    own.  Launch counters set to 0 before each and read after: no kernel of
    the port runs in an example.  What each printed and its host seconds
    (synchronised at the end)."""
    import contextlib
    import io
    import shutil

    import torch

    lm_release()
    root = ROOT / "build" / "chip_smoke" / "examples"
    shutil.rmtree(root, ignore_errors=True)
    runs = []
    for name, argv in EXAMPLE_RUNS:
        argv = [a.format(root=root) for a in argv]
        mod = load_example(name)
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), LoopLog() as loop_log:
            rc = mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        lm_no_kernel(f"examples {name}")
        lines = out.getvalue().splitlines()
        if rc != 0 or loop_log.retries:
            fail(f"examples {name} {argv}: exit {rc}, {loop_log.retries} retries")
        runs.append({"example": name, "argv": argv, "seconds": seconds, "stdout": lines,
                     "checked": check_example(name, argv, lines, loop_log.messages),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        print(f"chip_smoke: examples {name} {' '.join(argv)} {seconds:.1f} s",
              file=sys.stderr, flush=True)
        torch.cuda.reset_peak_memory_stats()
    shutil.rmtree(root, ignore_errors=True)
    out = {"phase": "examples", "runs": runs, "seconds": sum(r["seconds"] for r in runs)}
    emit(out)
    return out


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
    sweep_batched = timed(phase_sweep_batched, device)
    sweep_rows = timed(phase_sweep_rows, device)
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
    service = timed(phase_service_path, args.sources)
    serve_p = timed(phase_serve_path, args.sources)
    service_pdhg = timed(phase_service_pdhg_path, args.sources)
    timed(phase_dryrun, main_path, times)

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
    kernels = {"kernels": [
        entry("dual_oracle", "src/repro/kernels/dual_oracle.py:87",
              main_path["summary"]["kernel_launches"],
              max(worst(sweep), worst(sweep_batched), times["call"]["main_path_x_max_abs_err"],
                  pdhg_step["x_max_abs_err"]), times["call"],
              launches_by_path={"main": main_counts["dual_oracle"],
                                "pdhg": pdhg_counts["dual_oracle"],
                                "cadence": cadence["launches"],
                                "service": service["launches"],
                                "service_pdhg": service_pdhg["launches"]},
              batched={k: service["batched_call"][k] for k in (
                  "B", "kernel_ms", "device_ms", "solo_call_ms_x4", "plain_ms", "bound_ms",
                  "bound_by")},
              pdhg_step={k: pdhg_step[k] for k in ("kernel_ms", "device_ms", "plain_ms",
                                                   "bound_ms", "bound_by")},
              pdhg_step_batched={"launches": service_pdhg["launches"],
                                 **{k: service_pdhg["batched_step"][k] for k in (
                                     "B", "kernel_ms", "device_ms", "oracle_device_ms",
                                     "solo_steps_x4_device_ms", "plain_ms", "bound_ms",
                                     "bound_by")}}),
        entry("dual_oracle_finalize", "src/repro/kernels/ops.py:317",
              main_counts["dual_oracle_finalize"],
              times["finalize"]["lin_sq_max_abs_err"], times["finalize"], "dual_oracle",
              launches_by_path={"main": main_counts["dual_oracle_finalize"],
                                "pdhg": pdhg_counts["dual_oracle_finalize"],
                                "cadence": cadence["finalizes"],
                                "service": service["finalizes"],
                                "service_pdhg": service_pdhg["finalizes"]}),
        entry("dual_primal", "src/repro/kernels/dual_primal.py:100",
              path2["launch_counts"]["dual_primal"],
              max(worst(sweep2), worst(sweep_rows), times23["primal"]["main_path_max_abs_err"]),
              times23["primal"],
              launches_by_path={"path2": path2["launch_counts"]["dual_primal"],
                                "serve": serve_p["launches"]},
              rows={k: serve_p["query"][k] for k in (
                  "q", "device_ms", "kernel_event_ms", "host_ms", "bound_ms", "bound_by")}),
        entry("simplex_proj", "src/repro/kernels/simplex_proj.py:97",
              path3["launch_counts"]["simplex_proj"],
              max(worst(sweep3), times23["simplex"]["main_path_max_abs_err"]),
              times23["simplex"]),
    ]}

    # 9. the LM substrate's serving path, with the solver's tensors released
    del main_path, path2, path3, pdhg, pdhg_step, times, times23, cadence, service
    del serve_p, service_pdhg, sweep, sweep2, sweep3, sweep_batched, sweep_rows
    timed(phase_lm_serve_cli)
    timed(phase_lm_qwen3_8b)
    timed(phase_lm_deepseek_v2_2l)
    timed(phase_lm_mamba2)
    # 10. the LM substrate's training path
    timed(phase_lm_train_qwen3_8b)
    timed(phase_lm_train_cli)
    # 11. the LM substrate over a mesh
    mesh_train = timed(phase_lm_mesh_train_qwen3_8b)
    timed(phase_lm_mesh_serve_qwen3_8b)
    timed(phase_lm_mesh_dryrun, mesh_train)
    # 12. the port's examples
    timed(phase_examples)

    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
