"""Dry run: the bytes, FLOPs, collectives and memory of an LM cell (arch x
shape x mesh) or a solver cell, from the shapes alone (port of
`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single_pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 4 --out build/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --solver s100M-d10K --shards 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sources 1000000 \
        --destinations 10000 --avg-degree 8 --shards 1 --fused-oracle

Arch cells.  The reference lowers and compiles each cell's step for its
16 x 16 or 2 x 16 x 16 mesh.  The port runs the step itself, once, in a
child process that joins PyTorch's fake process group at the mesh's world
size (256 or 512; no card, no communication), on meta-device shards (no
storage): `training.train_step.lower_train_step`, `serving.lm_demo.steps`'
`lower_prefill` / `lower_decode_step`.  Each record has the reference's keys,
with what only XLA has replaced by what the trace measures, named as such:
`trace_s` (for `lower_s` / `compile_s`), `flop_counter_flops_per_device`
(`torch.utils.flop_counter`'s formulas over this rank's local ops, for
`hlo_flops_per_device`), `account_bytes_per_device` (the shards of params,
optimizer state, batch and cache, for `hlo_bytes_per_device`), the
collectives per device from the trace (`analysis.comm_stats`; loop-aware by
construction, so `coll_bytes_per_device_static` is null), and `memory`: the
state's shard bytes plus the trace's peak of its own live bytes (activations,
grads, temporaries), against the H100's 80 GB (`fits`).  Skipped cells carry
`configs.skip_reason`.  `--all` runs the reference's 80 cells (ten archs x
four SHAPES x both meshes), one child each (`--jobs` at a time), and with
`--with-solver` the solver cells too.  `--mesh host --mesh-shape 1,1` with
`--num-layers`, `--global-batch`, `--seq-len` sizes a cell by hand.

Solver cells.  The reference reads each cell's compiled artifact; the
port's record is analytic: the instance is one of meta-device tensors
(`instances.specs`, no storage), and each figure is computed from its
shapes with the reference's formulas and the port's own byte model
(`kernels.ops.oracle_slab_slot_bytes`, `oracle_hist_partial_bytes`).  The
keys that exist only with XLA (`lower_s`, `compile_s`, `hlo_*`) are left
out.  A solver record holds:

  * `model_flops`, `flops_global`, `bytes_global`: per stage of `--iters`
    iterations, the reference's formulas; the fused oracle's partial
    histogram is the port's int64 A x row per call and shard;
  * `oracle_call`: one fused-oracle call's bytes as kernel 1's bound counts
    them (each slot read once and x written once, lam read, A x, c'x and
    ||x||^2 written) and its bound on the card;
  * `collectives`: the packed [m*J + 2] reduction of `core.sharding` per
    iteration by `--comm-mode` and `--compress` (PDHG: its [m*J] A x
    reduction per iteration and its residual sums per check), and the stop
    vote per check when a tolerance is set; none at one shard;
  * `memory`: per shard, the instance's bytes and the solver's buffers, and
    whether they fit in the card's 80 GB;
  * `roofline`: the three terms on the H100 (`analysis.roofline.H100`).

"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.analysis.roofline import H100, H100_HBM_BYTES, roofline_from_stats
from repro_torch.configs import LP_INSTANCES
from repro_torch.core.maximizer import MaximizerConfig
from repro_torch.instances.buckets import BucketedInstance, slab_dtype_name
from repro_torch.instances.specs import solver_input_specs
from repro_torch.kernels import dual_oracle as kdo
from repro_torch.kernels import ops as kops

__all__ = ["ALL_SHARDS", "H100_SMS", "MESHES", "all_cells", "arch_cell", "build_parser",
           "main", "run_arch_cell", "run_solver_cell", "solver_cell"]

ALL_SHARDS = (1, 4, 8)  # the shard counts of `--all`
H100_SMS = 132  # streaming multiprocessors of the H100 SXM5


MESHES = {  # the reference's production meshes: shape, axis names
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def all_cells() -> list[tuple[str, str, str]]:
    """The reference's `_all_cells`: every arch x shape x production mesh."""
    from repro_torch.configs import ARCH_IDS, SHAPES

    return [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in ("single_pod", "multi_pod")]


def _cell_config(arch: str, shape_name: str, *, moe_groups=0, kv_dtype="", reduced=False,
                 num_layers=0, global_batch=0, seq_len=0):
    from repro_torch.configs import SHAPES, get_config, get_reduced_config

    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    if moe_groups and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, groups=moe_groups))
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    shape = SHAPES[shape_name]
    if global_batch or seq_len:
        shape = dataclasses.replace(shape, global_batch=global_batch or shape.global_batch,
                                    seq_len=seq_len or shape.seq_len)
    return cfg, shape


def _cell_name(arch, shape_name, mesh_name, mesh_shape) -> str:
    if mesh_name == "host":
        mesh_name = "host" + "x".join(str(n) for n in mesh_shape)
    return f"{arch}/{shape_name}/{mesh_name}"


def arch_cell(arch: str, shape_name: str, mesh_name: str, *, moe_groups: int = 0,
              kv_dtype: str = "", reduced: bool = False, num_layers: int = 0,
              global_batch: int = 0, seq_len: int = 0,
              mesh_shape: Optional[tuple] = None) -> dict:
    """The record of one arch cell, traced in this process over the running
    process group (whose world size must be the mesh's size)."""
    from repro_torch.analysis.flops_model import cell_cost
    from repro_torch.configs import input_specs, skip_reason
    from repro_torch.launch.mesh import default_profile, make_mesh
    from repro_torch.models.model import Model
    from repro_torch.serving.lm_demo.steps import lower_decode_step, lower_prefill
    from repro_torch.training.train_step import lower_train_step

    cfg, shape = _cell_config(arch, shape_name, moe_groups=moe_groups, kv_dtype=kv_dtype,
                              reduced=reduced, num_layers=num_layers,
                              global_batch=global_batch, seq_len=seq_len)
    dims, axes = _mesh_dims(mesh_name, mesh_shape)
    name = _cell_name(arch, shape_name, mesh_name, dims)
    reason = skip_reason(cfg, shape)
    if reason:
        return {"cell": name, "status": "skip", "reason": reason}
    mesh = make_mesh(dims, axes, "cpu")
    model = Model(cfg)
    specs = input_specs(cfg, shape, model)
    profile = default_profile(cfg, mesh)

    t0 = time.time()
    if shape.kind == "train":
        acc = lower_train_step(cfg, specs, mesh, profile)
    elif shape.kind == "prefill":
        acc = lower_prefill(cfg, specs, mesh, profile)
    else:
        acc = lower_decode_step(cfg, specs, mesh, profile)
    t_trace = time.time() - t0

    cost = cell_cost(cfg, shape)
    n = model.param_count()
    n_active = model.param_count(active_only=True)
    if shape.kind == "train":
        model_flops = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        model_flops = 2.0 * n_active * shape.global_batch
    state = {k: acc.get(k, 0) for k in ("params_bytes", "opt_bytes", "batch_bytes",
                                        "cache_bytes")}
    account = sum(state.values())
    estimate = account + acc["trace_live_peak_bytes"]
    return {
        "cell": name,
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": mesh_name,
        "mesh_shape": list(dims),
        "chips": int(mesh.size()),
        "status": "ok",
        "reduced": reduced,
        "num_layers": cfg.num_layers,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "profile": dataclasses.asdict(profile),
        "trace_s": round(t_trace, 2),
        "params": n,
        "active_params": n_active,
        "model_flops": model_flops,
        "flop_counter_flops_per_device": float(acc["flop_counter_flops_per_device"]),
        "account_bytes_per_device": float(account),
        # analytic totals (analysis/flops_model.py)
        "flops_global": cost.flops,
        "bytes_global": cost.bytes,
        "layer_fwd_flops": cost.layer_fwd_flops,
        "extra_flops": cost.extra_flops,
        "collectives": acc["collectives"],
        "coll_bytes_per_device": acc["coll_bytes_per_device"],
        # the eager trace runs every layer: no body-once count exists
        "coll_bytes_per_device_static": None,
        "memory": {
            **state,
            "trace_live_peak_bytes": acc["trace_live_peak_bytes"],
            "estimate_bytes": estimate,
            "device_bytes": H100_HBM_BYTES,
            "fits": estimate <= H100_HBM_BYTES,
        },
    }


def _mesh_dims(mesh_name: str, mesh_shape: Optional[tuple]):
    """(shape, axis names) of a production mesh, or of a host mesh of one or
    two dims (("data",) or ("data", "model"))."""
    if mesh_name == "host":
        dims = tuple(mesh_shape or (1, 1))
        if not 1 <= len(dims) <= 2:
            raise ValueError(f"a host mesh has 1 or 2 dims, not {dims}")
        return dims, ("data", "model")[:len(dims)]
    return MESHES[mesh_name]


def _child(kw: dict) -> int:
    """The child process of one arch cell: join the fake process group at
    the mesh's world size, trace the cell, print its record."""
    import math

    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dims, _ = _mesh_dims(kw["mesh_name"], kw.get("mesh_shape"))
    tdist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(dims))
    try:
        rec = arch_cell(kw.pop("arch"), kw.pop("shape_name"), kw.pop("mesh_name"), **kw)
    finally:
        tdist.destroy_process_group()
    print(json.dumps(rec))
    return 0


def run_arch_cell(arch: str, shape_name: str, mesh_name: str, moe_groups: int = 0,
                  kv_dtype: str = "", *, reduced: bool = False, num_layers: int = 0,
                  global_batch: int = 0, seq_len: int = 0,
                  mesh_shape: Optional[tuple] = None, timeout: Optional[float] = None) -> dict:
    """The record of one arch cell: skipped here when `configs.skip_reason`
    says so, else traced in a child process under the fake process group."""
    from repro_torch.configs import skip_reason

    cfg, shape = _cell_config(arch, shape_name, moe_groups=moe_groups, kv_dtype=kv_dtype,
                              reduced=reduced, num_layers=num_layers,
                              global_batch=global_batch, seq_len=seq_len)
    reason = skip_reason(cfg, shape)
    if reason:
        dims, _ = _mesh_dims(mesh_name, mesh_shape)
        return {"cell": _cell_name(arch, shape_name, mesh_name, dims), "status": "skip",
                "reason": reason}
    kw = dict(arch=arch, shape_name=shape_name, mesh_name=mesh_name, moe_groups=moe_groups,
              kv_dtype=kv_dtype, reduced=reduced, num_layers=num_layers,
              global_batch=global_batch, seq_len=seq_len,
              mesh_shape=list(mesh_shape) if mesh_shape else None)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_SRC, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell-child", json.dumps(kw)],
        capture_output=True, text=True, env=env, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"arch cell {arch}/{shape_name}/{mesh_name} failed:\n"
                           + proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _oracle_launch_grids(shapes, m: int, J: int) -> list[tuple[int, int]]:
    """(grid, hist_mode) of each launch of one fused-oracle call over slabs
    of `shapes` [(n, L)], as `kernels.dual_oracle.plan_slabs` sizes them,
    with one resident block per SM (the narrow kernel's launch bounds let a
    thread take 65536/threads registers; the runtime's occupancy answer
    needs the card)."""
    out = []
    narrow = [(n, L) for n, L in shapes if L <= 32 and n > 0]
    for c in range(0, len(narrow), kdo.MAX_SLABS):
        group = narrow[c:c + kdo.MAX_SLABS]
        lay = kdo.oracle_layout(max(L for _, L in group), m, J)
        tasks = kdo.narrow_tasks(group)[1]
        out.append((max(1, min(H100_SMS, -(-tasks // lay.warps))), lay.hist_mode))
    for n, L in shapes:
        if L > 32 and n > 0:
            lay = kdo.oracle_layout(L, m, J)
            out.append((max(1, min(H100_SMS, -(-n // lay.warps))), lay.hist_mode))
    return out


def _oracle_partial_bytes(shapes, m: int, J: int) -> int:
    """The int64 A x row's traffic of one call (`ops.oracle_hist_partial_bytes`):
    the row zeroed and read once per call, one add per bin and block of the
    launches whose histogram is in shared memory."""
    grids = _oracle_launch_grids(shapes, m, J)
    return kops.oracle_hist_partial_bytes(
        sum(g for g, mode in grids if mode == kdo.HIST_SHARED), m, J)


def _collectives(dual: int, iters: int, shards: int, *, engine: str, comm_mode: str,
                 compress: str, early_stop: bool) -> dict:
    """The per-stage collectives of a sharded solve and their operand bytes
    per device (none at one shard); checks every `MaximizerConfig`'s
    `check_every`, PDHG with its default (adaptive) restart."""
    counts: dict[str, int] = {}
    byts: dict[str, int] = {}

    def add(op, n, size):
        counts[op] = counts.get(op, 0) + n
        byts[op] = byts.get(op, 0) + n * size

    if shards > 1:
        checks = -(-iters // MaximizerConfig().check_every)
        if engine == "pdhg":  # A x+ per iteration; two residual sums per check
            add("all-reduce", iters, 4 * dual)
            add("all-reduce", 2 * checks, 4 * 3)
        else:  # the packed [m*J + 2] payload
            size = (2 if compress != "none" else 4) * (dual + 2)
            if comm_mode == "rank0":
                add("reduce", iters, size)
                add("broadcast", iters, size)
            else:
                add("all-reduce", iters, size)
        if early_stop:
            add("all-reduce", checks, 4)  # the unanimous stop vote (int32)
    return {"counts": counts, "bytes": byts}


def _memory(inst: BucketedInstance, shards: int, *, engine: str, fused_oracle: bool) -> dict:
    """Per-shard device bytes: the instance's slabs (a block of rows of each
    bucket) and rhs, then the solver's buffers: the x slabs (the iterate and
    its successor), the working slabs of the engine's path, the duals and
    the oracle's int64 A x row with its partials."""
    m, J = inst.num_families, inst.num_destinations
    dual = m * J
    local = [(b.rows // shards, b.length) for b in inst.buckets]
    slots = sum(n * L for n, L in local)
    big = max(n * L for n, L in local)
    itemsize = inst.buckets[0].coeff.element_size()
    quantized = inst.buckets[0].coeff_scale is not None
    instance = sum(
        (_nbytes(b.idx) + _nbytes(b.coeff) + _nbytes(b.cost) + _nbytes(b.mask)) // shards
        + _nbytes(b.coeff_scale) + _nbytes(b.cost_scale)
        for b in inst.buckets) + _nbytes(inst.rhs)
    fused = fused_oracle and engine in ("agd", "pdhg")
    x_item = 4 if (quantized or not fused) else itemsize
    x_slabs = 2 * slots * x_item
    if engine == "pdhg":
        # the adaptive restart's window sum; the fused step's cost_eff
        # buffers and scratch, else the plain step's candidate and
        # projection temporaries of the largest bucket
        work = slots * 4 + (slots * 4 + big * 4 if fused else (8 + 3 * m) * 4 * big)
        duals = 10 * dual * 4
    elif fused:
        work = 0
        duals = 8 * dual * 4
    else:
        # the fixed-order A x: each bucket's sorted slot order (int64), and
        # the plain oracle's temporaries of the largest bucket
        work = sum(8 * m * n * L + 8 * (dual + 1) for n, L in local) + (8 + 3 * m) * 4 * big
        duals = 8 * dual * 4
    grid_rows = sum(g for g, _ in _oracle_launch_grids(local, m, J)) if fused_oracle else 0
    scratch = 8 * dual + 8 * grid_rows + 4 * (dual + 2) if fused_oracle else 0
    total = instance + x_slabs + work + duals + scratch
    return {"instance_bytes": instance, "x_slab_bytes": x_slabs, "work_bytes": work,
            "dual_bytes": duals, "oracle_scratch_bytes": scratch,
            "estimate_bytes": total, "device_bytes": H100_HBM_BYTES,
            "fits": total <= H100_HBM_BYTES}


def _refuse(formulation: str, engine: str, fused_kernel: bool, fused_oracle: bool) -> str:
    """The reference's refusals; returns the engine a cell runs."""
    if formulation != "matching" and (fused_kernel or fused_oracle):
        raise ValueError("fused kernels implement the simplex feasible set; "
                         "only the matching formulation can use them")
    engine = "agd" if engine == "auto" else engine  # auto: service policy
    if engine == "pdhg":
        if formulation != "matching":
            raise ValueError("engine pdhg solves the simplex-constrained "
                             "matching LP; only formulation matching applies")
        if fused_kernel:
            raise ValueError("engine pdhg fuses its prox step through the "
                             "one-pass dual oracle; use fused_oracle")
    return engine


def solver_cell(inst: BucketedInstance, name: str, shards: int, *, comm_mode="psum",
                compress="none", iters: int = 100, fused_kernel: bool = False,
                fused_oracle: bool = False, tol_grad: Optional[float] = None,
                tol_viol: Optional[float] = None, formulation: str = "matching",
                engine: str = "agd") -> dict:
    """The dry-run record of `inst` (meta-device or real tensors: only
    shapes and dtypes are read) solved over `shards` processes."""
    from repro_torch.core.sharding import COMM_MODES, COMPRESS
    from repro_torch.formulation import scenario_formulation

    engine = _refuse(formulation, engine, fused_kernel, fused_oracle)
    scenario_formulation(formulation)  # refuses an unknown name
    if comm_mode not in COMM_MODES or compress not in COMPRESS:
        raise ValueError(f"comm_mode {comm_mode!r} / compress {compress!r}")
    if shards < 1 or any(b.rows % shards for b in inst.buckets):
        raise ValueError(f"every bucket's rows must split over {shards} shards")
    m, J = inst.num_families, inst.num_destinations
    dtype = slab_dtype_name(inst.buckets[0].coeff.dtype)
    isz = inst.buckets[0].coeff.element_size()
    slot_bytes = kops.oracle_slab_slot_bytes(m, dtype)
    sizes = [(b.rows, b.length) for b in inst.buckets]
    nnz = float(sum(n * L for n, L in sizes))  # upper bound incl. padding
    local = [(n // shards, L) for n, L in sizes]
    partial = shards * _oracle_partial_bytes(local, m, J)
    unfused_slot = 4 + 3 * isz + isz + (0 if fused_kernel else 8) + 4 + 4 * isz
    bytes_global = float(iters * (
        sum((slot_bytes if fused_oracle else unfused_slot) * n * L for n, L in sizes)
        + (partial if fused_oracle else 0)))
    flops_global = float(iters * sum((8 + L.bit_length() ** 2) * n * L for n, L in sizes))
    call_bytes = int(nnz) * slot_bytes + shards * (4 * m * J * 2 + 8)
    early = tol_grad is not None or tol_viol is not None
    coll = _collectives(m * J, iters, shards, engine=engine, comm_mode=comm_mode,
                        compress=compress, early_stop=early)
    coll_bytes = float(sum(coll["bytes"].values()))
    model_flops = 4.0 * nnz * iters  # 2 SpMVs (2 flops per slot) per iteration
    terms = roofline_from_stats(flops_global / shards, bytes_global / shards, coll_bytes,
                                shards, H100, model_flops)
    return {
        "cell": f"solver-{name}/{comm_mode}+{compress}/shards{shards}"
                + ("" if formulation == "matching" else f"/{formulation}")
                + ("" if engine == "agd" else f"/{engine}"),
        "arch": f"solver-{name}",
        "formulation": formulation,
        "engine": engine,
        "shape": f"stage{iters}",
        "kind": "solver",
        "shards": shards,
        "chips": shards,
        "device": H100.name,
        "status": "ok",
        "slab_dtype": dtype,
        "slots": int(nnz),
        "buckets": [[L, n] for n, L in sizes],
        "model_flops": model_flops,
        "flops_global": flops_global,
        "bytes_global": bytes_global,
        "oracle_call": {
            "bytes": call_bytes,
            "hist_partial_bytes": partial,
            "grids": [g for g, _ in _oracle_launch_grids(local, m, J)],
            "bound_ms": call_bytes / shards / H100.hbm_bw * 1e3,
        },
        "collectives": coll,
        "coll_bytes_per_device": coll_bytes,
        "memory": _memory(inst, shards, engine=engine, fused_oracle=fused_oracle),
        "roofline": {**terms.to_dict(), "bound_s": terms.bound_s, "hw": H100.name},
    }


def run_solver_cell(inst_name: str, shards: int, *, comm_mode="psum", compress="none",
                    iters: int = 100, slab_dtype: str = "float32",
                    fused_kernel: bool = False, fused_oracle: bool = False,
                    tol_grad: Optional[float] = None, tol_viol: Optional[float] = None,
                    formulation: str = "matching", engine: str = "agd",
                    spec: Optional[dict] = None) -> dict:
    """The record of `LP_INSTANCES[inst_name]` (or of `spec`, a generator
    spec sized by hand) on the analytic layout, rows padded to `shards`."""
    _refuse(formulation, engine, fused_kernel, fused_oracle)
    spec = spec or LP_INSTANCES[inst_name]
    inst = solver_input_specs(
        spec["num_sources"], spec["num_destinations"], spec["num_families"],
        spec["avg_degree"], shard_multiple=shards, dtype=slab_dtype)
    return solver_cell(inst, inst_name, shards, comm_mode=comm_mode, compress=compress,
                       iters=iters, fused_kernel=fused_kernel, fused_oracle=fused_oracle,
                       tol_grad=tol_grad, tol_viol=tol_viol, formulation=formulation,
                       engine=engine)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", help="an LM cell: architecture (configs.ARCH_IDS), with --shape")
    ap.add_argument("--shape", help="an LM cell's shape (configs.SHAPES)")
    ap.add_argument("--mesh", default="single_pod", choices=[*MESHES, "host"],
                    help="an LM cell's mesh; host takes --mesh-shape")
    ap.add_argument("--mesh-shape", default="1,1",
                    help="with --mesh host: the (data, model) sizes, e.g. 1,1")
    ap.add_argument("--moe-groups", type=int, default=0)
    ap.add_argument("--kv-dtype", default="")
    ap.add_argument("--reduced", action="store_true", help="the arch's REDUCED config")
    ap.add_argument("--num-layers", type=int, default=0, help="cut the config's depth")
    ap.add_argument("--global-batch", type=int, default=0, help="override the shape's batch")
    ap.add_argument("--seq-len", type=int, default=0, help="override the shape's sequence")
    ap.add_argument("--solver", help=f"one of {sorted(LP_INSTANCES)}")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--sources", type=int, default=None,
                    help="size a cell by hand (with --destinations, --avg-degree)")
    ap.add_argument("--destinations", type=int, default=10_000)
    ap.add_argument("--avg-degree", type=float, default=10.0)
    ap.add_argument("--families", type=int, default=1)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--comm-mode", default="psum", choices=["psum", "rank0"])
    ap.add_argument("--compress", default="none", choices=["none", "bf16", "bf16_ef"])
    ap.add_argument("--slab-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--fused-kernel", action="store_true")
    ap.add_argument("--fused-oracle", action="store_true")
    ap.add_argument("--tol-grad", type=float, default=None)
    ap.add_argument("--tol-viol", type=float, default=None)
    ap.add_argument("--engine", default="agd", choices=["agd", "pdhg", "auto"],
                    help="solver engine of the cell; auto falls back to agd")
    ap.add_argument("--formulation", default="matching",
                    choices=["matching", "capacity-cap", "fairness-floor", "budget-pacing"])
    ap.add_argument("--tag", default="", help="suffix for the output json")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape x mesh cell (the reference's 80)")
    ap.add_argument("--with-solver", action="store_true",
                    help=f"with --all: also every LP_INSTANCES cell at shards {ALL_SHARDS}")
    ap.add_argument("--jobs", type=int, default=4, help="--all: cells traced at a time")
    ap.add_argument("--cell-child", help=argparse.SUPPRESS)
    return ap


def _arch_tag(arch, shape, mesh, extra="") -> str:
    return f"{arch}__{shape}__{mesh}" + (f"__{extra}" if extra else "")


def _summary(rec: dict) -> dict:
    out = {k: rec[k] for k in ("cell", "status", "reason") if k in rec}
    if rec.get("status") == "ok":
        mem = rec["memory"]
        out.update(memory_gb_per_device=mem["estimate_bytes"] / 1e9, fits=mem["fits"],
                   coll_bytes_per_device=rec["coll_bytes_per_device"],
                   trace_s=rec["trace_s"])
    return out


def _write(out_dir: str, tag: str, rec: dict) -> None:
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=2)


def _drive_all(out_dir: str, jobs: int) -> int:
    """Every arch cell, each traced in a child process (`jobs` at a time);
    cells with a record in `out_dir` are kept.  Returns the failures."""
    from repro_torch.configs import skip_reason

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_SRC, env.get("PYTHONPATH")) if p)
    queue, running, failures = [], [], 0
    for arch, shape, mesh in all_cells():
        tag = _arch_tag(arch, shape, mesh)
        if os.path.exists(os.path.join(out_dir, tag + ".json")):
            print("cached:", tag, flush=True)
            continue
        cfg, spec = _cell_config(arch, shape)
        reason = skip_reason(cfg, spec)
        if reason:
            rec = {"cell": f"{arch}/{shape}/{mesh}", "status": "skip", "reason": reason}
            _write(out_dir, tag, rec)
            print(json.dumps(_summary(rec)), flush=True)
            continue
        queue.append((tag, dict(arch=arch, shape_name=shape, mesh_name=mesh)))
    while queue or running:
        while queue and len(running) < jobs:
            tag, kw = queue.pop(0)
            log = open(os.path.join(out_dir, tag + ".log"), "w")
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell-child",
                 json.dumps(kw)], stdout=subprocess.PIPE, stderr=log, text=True, env=env)
            running.append((proc, tag, log))
        time.sleep(0.5)
        still = []
        for proc, tag, log in running:
            if proc.poll() is None:
                still.append((proc, tag, log))
                continue
            out = proc.stdout.read()
            log.close()
            if proc.returncode != 0:
                failures += 1
                print("FAIL", tag, flush=True)
                continue
            rec = json.loads(out.strip().splitlines()[-1])
            _write(out_dir, tag, rec)
            print(json.dumps(_summary(rec)), flush=True)
        running = still
    return failures


def _tag(args, name: str, shards: int) -> str:
    tag = f"solver-{name}__shards{shards}"
    if args.comm_mode != "psum" or args.compress != "none":
        tag += f"__{args.comm_mode}-{args.compress}"
    if args.fused_oracle:
        tag += "__fusedoracle"
    if args.slab_dtype != "float32":
        tag += f"__{args.slab_dtype}"
    if args.tol_grad is not None or args.tol_viol is not None:
        tag += "__earlystop"
    if args.formulation != "matching":
        tag += f"__{args.formulation}"
    if args.engine != "agd":
        tag += f"__{args.engine}"
    return tag + (f"__{args.tag}" if args.tag else "")


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cell_child:
        return _child(json.loads(args.cell_child))
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    cells = []
    if args.all:
        failures += _drive_all(args.out, args.jobs)
        if args.with_solver:
            cells = [(name, None, s) for name in LP_INSTANCES for s in ALL_SHARDS]
    elif args.arch:
        if not args.shape:
            build_parser().error("--arch needs --shape")
        mesh_shape = tuple(int(n) for n in args.mesh_shape.split(","))
        try:
            rec = run_arch_cell(args.arch, args.shape, args.mesh, moe_groups=args.moe_groups,
                                kv_dtype=args.kv_dtype, reduced=args.reduced,
                                num_layers=args.num_layers, global_batch=args.global_batch,
                                seq_len=args.seq_len, mesh_shape=mesh_shape)
        except (RuntimeError, KeyError, ValueError):
            traceback.print_exc()
            return 1
        mesh = args.mesh if args.mesh != "host" else "host" + "x".join(map(str, mesh_shape))
        _write(args.out, _arch_tag(args.arch, args.shape, mesh, args.tag), rec)
        print(json.dumps(_summary(rec)))
        return 0
    elif args.sources is not None:
        spec = dict(num_sources=args.sources, num_destinations=args.destinations,
                    avg_degree=args.avg_degree, num_families=args.families)
        cells = [(f"s{args.sources}-d{args.destinations}", spec, args.shards)]
    elif args.solver:
        cells = [(args.solver, None, args.shards)]
    else:
        build_parser().error("give --arch NAME --shape S, --solver NAME, --sources N or --all")
    for name, spec, shards in cells:
        try:
            rec = run_solver_cell(
                name, shards, comm_mode=args.comm_mode, compress=args.compress,
                iters=args.iters, slab_dtype=args.slab_dtype,
                fused_kernel=args.fused_kernel, fused_oracle=args.fused_oracle,
                tol_grad=args.tol_grad, tol_viol=args.tol_viol,
                formulation=args.formulation, engine=args.engine, spec=spec)
        except (ValueError, KeyError):
            traceback.print_exc()
            failures += 1
            continue
        with open(os.path.join(args.out, _tag(args, name, shards) + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
        mem, roof = rec["memory"], rec["roofline"]
        print(json.dumps({"cell": rec["cell"], "status": rec["status"],
                          "bytes_global": rec["bytes_global"],
                          "memory_gb_per_shard": mem["estimate_bytes"] / 1e9,
                          "fits": mem["fits"], "dominant": roof["dominant"],
                          "bound_s": roof["bound_s"]}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
