"""Port parity: the solver dry run (`launch.dryrun`, `instances.specs`,
`configs.LP_INSTANCES`, `analysis.roofline`) against the JAX package.

  * `production_bucket_shapes` equal to the reference's (both sample the
    Appendix-A generator at 1M sources); `solver_input_specs` the
    reference's `ShapeDtypeStruct`s shape for shape and dtype for dtype
    (fp32 and int8), as meta-device tensors.
  * `model_flops`, `flops_global` and `bytes_global` equal to the
    reference's formulas (`repro/launch/dryrun.py:214-250`) evaluated on the
    reference's specs; for the fused oracle the partial-histogram term is
    the port's int64 A x row (`kernels.ops.oracle_hist_partial_bytes`), and
    the per-slot term the reference's `oracle_slab_slot_bytes`.
  * `roofline_from_stats` equal to the reference's given the same `HW`.
  * The CLI on the CPU for one `LP_INSTANCES` cell at shards 1 and 4, and
    its refusals.
  * Arch cells of the reduced configs, each traced in a child process under
    PyTorch's fake process group at the production mesh's world size:
    `ok` with the reference's record keys (what only XLA has replaced by the
    trace's own, named as such), or the reference's skip reason.
The reference's `repro.launch.dryrun` is not imported: it sets XLA_FLAGS
for 512 host devices when imported.
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.analysis import roofline as jroof
from repro.configs import LP_INSTANCES as JAX_LP_INSTANCES
from repro.instances import specs as jspecs
from repro.kernels import ops as jops
from repro_torch.analysis import roofline as troof
from repro_torch.configs import LP_INSTANCES
from repro_torch.instances import specs as tspecs
from repro_torch.launch import dryrun

CELL = "s25M-d10K"


def test_lp_instances_are_the_reference_configs():
    assert LP_INSTANCES == JAX_LP_INSTANCES


def test_production_bucket_shapes_match_reference():
    for kw in (dict(avg_degree=10.0, shard_multiple=4), dict(avg_degree=10.0)):
        got = tspecs.production_bucket_shapes(25_000_000, 10_000, 1, **kw)
        assert got == jspecs.production_bucket_shapes(25_000_000, 10_000, 1, **kw)
        assert all(rows % kw.get("shard_multiple", 1) == 0 for _, rows in got)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_solver_input_specs_match_reference(dtype):
    got = tspecs.solver_input_specs(25_000_000, 10_000, 2, 10.0, shard_multiple=4,
                                    dtype=dtype)
    want = jspecs.solver_input_specs(25_000_000, 10_000, 2, 10.0, shard_multiple=4,
                                     dtype=jnp.dtype(dtype))
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        assert gb.length == wb.length
        for name in ("idx", "coeff", "cost", "mask", "coeff_scale", "cost_scale"):
            g, w = getattr(gb, name), getattr(wb, name)
            if w is None:
                assert g is None, name
                continue
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), name
            assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name, name
    assert tuple(got.rhs.shape) == tuple(want.rhs.shape) and got.rhs.dtype == torch.float32
    assert jnp.dtype(want.rhs.dtype) == jnp.float32 and got.rhs.device.type == "meta"
    assert (got.num_sources, got.num_destinations, got.num_families) == (
        want.num_sources, want.num_destinations, want.num_families)


def _reference_formulas(spec_j, iters, dtype, fused_kernel, fused_oracle, partial):
    """`repro/launch/dryrun.py:214-250` on the reference's specs; `partial`
    is the port's per-stage partial-histogram bytes."""
    isz = jnp.dtype(dtype).itemsize
    slots = [float(np.prod(b.cost.shape)) for b in spec_j.buckets]
    flops = float(iters * sum((8 + b.length.bit_length() ** 2) * s
                              for b, s in zip(spec_j.buckets, slots)))
    per_slot = (jops.oracle_slab_slot_bytes(1, jnp.dtype(dtype).name) if fused_oracle
                else 4 + 3 * isz + isz + (0 if fused_kernel else 8) + 4 + 4 * isz)
    byts = float(iters * sum(per_slot * s for s in slots)) + (partial if fused_oracle else 0)
    return 4.0 * sum(slots) * iters, flops, byts


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("dtype,fused_kernel,fused_oracle", [
    ("float32", False, False), ("float32", True, False), ("float32", False, True),
    ("bfloat16", False, True), ("int8", False, False)])
def test_solver_cell_formulas_match_reference(shards, dtype, fused_kernel, fused_oracle):
    spec = LP_INSTANCES[CELL]
    rec = dryrun.run_solver_cell(CELL, shards, slab_dtype=dtype, iters=100,
                                 fused_kernel=fused_kernel, fused_oracle=fused_oracle)
    spec_j = jspecs.solver_input_specs(spec["num_sources"], spec["num_destinations"],
                                       spec["num_families"], spec["avg_degree"],
                                       shard_multiple=shards, dtype=jnp.dtype(dtype))
    partial = 100 * rec["oracle_call"]["hist_partial_bytes"]
    model, flops, byts = _reference_formulas(spec_j, 100, dtype, fused_kernel, fused_oracle,
                                             partial)
    assert rec["model_flops"] == model
    assert rec["flops_global"] == flops
    assert rec["bytes_global"] == byts
    assert rec["buckets"] == [[b.length, b.cost.shape[0]] for b in spec_j.buckets]
    # one fused-oracle call as kernel 1's bound counts it
    slot_bytes = jops.oracle_slab_slot_bytes(1, jnp.dtype(dtype).name)
    assert rec["oracle_call"]["bytes"] == rec["slots"] * slot_bytes + shards * (8 * 10_000 + 8)
    if fused_oracle:
        assert rec["oracle_call"]["hist_partial_bytes"] > 0
    r = rec["roofline"]
    assert r["chips"] == shards and r["bytes_per_device"] == byts / shards
    assert r["hw"] == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_roofline_matches_reference_on_the_same_hw():
    hw = troof.H100
    want = jroof.roofline_from_stats(3.1e12, 2.2e11, 4.0e8, 4,
                                     hw=jroof.HW(**dataclasses.asdict(hw)), model_flops=1e12)
    got = troof.roofline_from_stats(3.1e12, 2.2e11, 4.0e8, 4, hw=hw, model_flops=1e12)
    assert got.to_dict() == want.to_dict()
    assert (got.bound_s, got.mfu_bound) == (want.bound_s, want.mfu_bound)
    assert troof.roofline_from_stats(1.0, 1.0, 1.0, 1).compute_s == 1.0 / 989.4e12
    assert not hasattr(troof, "V5E")


def test_dryrun_cli_on_the_cpu(tmp_path, capsys):
    for shards in (1, 4):
        assert dryrun.main(["--solver", CELL, "--shards", str(shards), "--fused-oracle",
                            "--tol-grad", "1e-4", "--out", str(tmp_path)]) == 0
        rec = json.loads((tmp_path / f"solver-{CELL}__shards{shards}__fusedoracle__earlystop.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["shards"] == shards and rec["chips"] == shards
        assert {"lower_s", "compile_s", "hlo_flops_per_device"}.isdisjoint(rec)
        mem = rec["memory"]
        assert mem["fits"] and 0 < mem["estimate_bytes"] < mem["device_bytes"]
        assert mem["instance_bytes"] < mem["estimate_bytes"]
        coll = rec["collectives"]
        if shards == 1:
            assert coll["counts"] == {} and rec["coll_bytes_per_device"] == 0.0
        else:  # the packed [m*J + 2] payload per iteration, a vote per check
            assert coll["counts"] == {"all-reduce": 100 + 4}
            assert coll["bytes"]["all-reduce"] == 100 * 4 * 10_002 + 4 * 4
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["cell"] for ln in lines] == [f"solver-{CELL}/psum+none/shards{s}" for s in (1, 4)]
    # four shards: a quarter of the slabs each
    one, four = (json.loads((tmp_path / f"solver-{CELL}__shards{s}__fusedoracle__earlystop.json")
                            .read_text())["memory"] for s in (1, 4))
    assert 3.5 < one["instance_bytes"] / four["instance_bytes"] <= 4.0


def test_dryrun_refusals():
    with pytest.raises(SystemExit):  # an arch cell needs its shape
        dryrun.main(["--arch", "qwen3-8b"])
    with pytest.raises(ValueError, match="simplex"):
        dryrun.run_solver_cell(CELL, 1, fused_oracle=True, formulation="capacity-cap")
    with pytest.raises(ValueError, match="use fused_oracle"):
        dryrun.run_solver_cell(CELL, 1, fused_kernel=True, engine="pdhg")
    with pytest.raises(ValueError, match="only formulation matching"):
        dryrun.run_solver_cell(CELL, 1, engine="pdhg", formulation="fairness-floor")
    assert dryrun.run_solver_cell(CELL, 4, engine="auto")["engine"] == "agd"


def test_arch_cell_train_on_the_fake_single_pod(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--mesh", "single_pod",
                        "--reduced", "--seq-len", "256", "--global-batch", "32",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen3-8b__train_4k__single_pod.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["mesh_shape"] == [16, 16]
    assert {"lower_s", "compile_s", "hlo_flops_per_device"}.isdisjoint(rec)
    for key in ("params", "active_params", "model_flops", "flops_global", "bytes_global",
                "layer_fwd_flops", "extra_flops", "collectives", "coll_bytes_per_device",
                "flop_counter_flops_per_device", "account_bytes_per_device", "trace_s"):
        assert key in rec, key
    assert rec["coll_bytes_per_device_static"] is None
    assert rec["flop_counter_flops_per_device"] > 0 and rec["coll_bytes_per_device"] > 0
    assert set(rec["collectives"]["counts"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                                 "all-to-all", "broadcast"}
    mem = rec["memory"]
    # per-shard params, both moments and the batch; the trace's own bytes on top
    assert mem["opt_bytes"] == 2 * mem["params_bytes"] > 0
    assert mem["estimate_bytes"] == (mem["params_bytes"] + mem["opt_bytes"] + mem["batch_bytes"]
                                     + mem["trace_live_peak_bytes"])
    assert mem["fits"] and mem["device_bytes"] == 80e9
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["status"] == "ok"


def test_arch_cells_decode_and_skip():
    rec = dryrun.run_arch_cell("mamba2-1.3b", "long_500k", "multi_pod", reduced=True)
    assert rec["status"] == "ok" and rec["chips"] == 512 and rec["kind"] == "decode"
    assert rec["memory"]["cache_bytes"] > 0 and rec["memory"]["opt_bytes"] == 0
    skip = dryrun.run_arch_cell("qwen3-8b", "long_500k", "single_pod")
    assert skip == {"cell": "qwen3-8b/long_500k/single_pod", "status": "skip",
                    "reason": "full-attention arch: 500k decode needs sub-quadratic mixing"}
    assert len(dryrun.all_cells()) == 80
