"""The LM substrate over a mesh (`make_train_step` and `make_serve_fns` with a
`DeviceMesh`, `train_loop(mesh=...)`) in spawned processes over gloo.

The reduced qwen3-8b, deepseek-v2 and mamba2 in fp32 run on the meshes (2,)
`data` and (2, 2) `data x model` (a group of 2 and one of 4 processes, run
at the same time, one thread each, joined through files in the test's tmp
directory), FSDP forced on once for qwen3-8b on (2, 2).  Against the single-process port:

  * five sharded train steps' losses at rtol 1e-4 (tests/test_torch_train_step.py's
    bound; ROADMAP Queue 3 says why losses, not params: AdamW's first step);
  * one `value_and_grad`: every gathered grad within 1e-5 of the leaf's
    largest |g|;
  * each rank's local shard shapes equal what the rules give;
  * `make_serve_fns`: prefill and three greedy decode steps' logits within
    1e-5;
  * 4 microbatches over the mesh (the reference's split of the global
    batch): losses at rtol 1e-4;
  * a mesh `train_loop` checkpoint restores on one process bit for bit, and
    a mesh loop resumed from its own step-2 checkpoint ends bitwise where
    the uninterrupted run ends.

And one test holds the reduced qwen3-8b's 5-step sharded losses against the
reference's `make_train_step` on a one-device JAX mesh.  This module imports
JAX only inside that test, because the spawned processes import it.
"""
import dataclasses
import logging
import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs as tconfigs
from repro_torch.checkpoint.manager import CheckpointManager, _items
from repro_torch.data import SyntheticLMData
from repro_torch.launch import dist as launch_dist
from repro_torch.launch.mesh import default_profile, make_mesh
from repro_torch.models.model import Model
from repro_torch.serving.lm_demo import make_serve_fns
from repro_torch.serving.lm_demo.steps import shard_tree
from repro_torch.training import (
    AdamWConfig, TrainLoopConfig, init_train_state, make_train_step, train_loop,
    value_and_grad,
)
from repro_torch.training.loop import batch_to_device
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.sharding_rules import batch_pspecs, named, param_pspecs
from repro_torch.training.train_step import (
    activation_sharding, gather_state, init_sharded_state,
)

ARCHS = ("qwen3-8b", "deepseek-v2-236b", "mamba2-1.3b")
MESHES = {"2": ((2,), ("data",)), "2x2": ((2, 2), ("data", "model"))}
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 5
B, S = 4, 16


def fp32(arch):
    return dataclasses.replace(tconfigs.get_reduced_config(arch), dtype="float32")


def _train(model, step, state, steps=STEPS):
    data = SyntheticLMData(model.cfg, batch=B, seq=S, seed=1)
    out = []
    for k in range(steps):
        state, m = step(state, batch_to_device(data(k), "cpu"))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _serve(model, params, prefill, decode, full):
    """Prefill 4 prompts of 12 tokens into a 16-deep cache, then 3 greedy
    decode steps; the logits of each call."""
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, model.cfg.vocab_size, (B, 12), generator=g, dtype=torch.int32)
    logits, cache = prefill(params, {"tokens": tokens}, 16)
    outs = [full(logits)]
    for t in range(3):
        tok = full(logits).argmax(-1).to(torch.int32).reshape(B, 1)
        logits, cache = decode(params, tok, 12 + t, cache)
        outs.append(full(logits))
    return [o.numpy() for o in outs]


def _expected_local(shape, spec, sizes):
    out = list(shape)
    for d, axes in enumerate(spec):
        if axes is not None:
            for a in (axes,) if isinstance(axes, str) else axes:
                out[d] //= sizes[a]
    return tuple(out)


# -- what each spawned process runs (rank 0 returns the results) -------------


def _suite(mesh_key, tmp, ref_state=None):
    dims, axes = MESHES[mesh_key]
    mesh = make_mesh(dims, axes, "cpu")
    sizes = dict(zip(axes, dims))
    out = {}
    runs = [(a, False) for a in ARCHS] + ([("qwen3-8b", True)] if mesh_key == "2x2" else [])
    for arch, fsdp in runs:
        model = Model(fp32(arch))
        profile = default_profile(model.cfg, mesh)
        profile = dataclasses.replace(profile, fsdp=True) if fsdp else profile
        key = f"{arch}{'-fsdp' if fsdp else ''}"
        state = init_sharded_state(model, mesh, profile, torch.Generator().manual_seed(0))
        specs = param_pspecs(model.init(None, device="meta"), mesh, profile)
        shapes_ok = all(
            tuple(x.to_local().shape) == _expected_local(x.shape, spec, sizes)
            for x, spec in zip(tree_leaves(state.params), tree_leaves(specs)))
        data = SyntheticLMData(model.cfg, batch=B, seq=S, seed=1)
        batch = batch_to_device(data(0), "cpu")
        batch = shard_tree(batch, mesh, named(mesh, batch_pspecs(batch, profile, mesh)))
        model.act_sharding = activation_sharding(model.cfg, mesh, profile, S)
        with implicit_replication():
            _, grads = value_and_grad(model, state.params, batch)
        model.act_sharding = None
        grads = {k: g.full_tensor().numpy() for k, g in _items(grads)}
        step, _, _ = make_train_step(model, OPT, mesh, profile)
        rec = {"losses": _train(model, step, state), "grads": grads, "shapes_ok": shapes_ok}
        if not fsdp:
            prefill, decode = make_serve_fns(model, mesh, profile)
            params = model.init(torch.Generator().manual_seed(0))
            rec["serve"] = _serve(model, params, prefill, decode, lambda x: x.full_tensor())
        out[key] = rec
    if mesh_key == "2":
        out["micro"] = _micro(mesh)
        out["loop"] = _loop(mesh, tmp)
        if ref_state is not None:
            out["reference"] = _from_reference(mesh, ref_state)
    return out


def _micro(mesh=None):
    """3 steps of reduced gemma-7b with 4 microbatches of 2 (the
    reference's split of the global batch)."""
    model = Model(fp32("gemma-7b"))
    data = SyntheticLMData(model.cfg, batch=8, seq=S, seed=1)
    if mesh is None:
        state = init_train_state(model, torch.Generator().manual_seed(0), device="cpu")
        step, _, _ = make_train_step(model, OPT, microbatches=4)
    else:
        profile = default_profile(model.cfg, mesh)
        state = init_sharded_state(model, mesh, profile, torch.Generator().manual_seed(0))
        step, _, _ = make_train_step(model, OPT, mesh, profile, microbatches=4)
    out = []
    for k in range(3):
        state, m = step(state, batch_to_device(data(k), "cpu"))
        out.append(float(m["loss"]))
    return out


def _loop(mesh, tmp):
    model = Model(fp32("qwen3-8b"))
    profile = default_profile(model.cfg, mesh)
    data = SyntheticLMData(model.cfg, batch=B, seq=S, seed=1)
    loop = TrainLoopConfig(total_steps=4, save_every=2, log_every=0)
    a, b = os.path.join(tmp, "loop-a"), os.path.join(tmp, "loop-b")
    full = gather_state(train_loop(model, data, OPT, loop, a, mesh=mesh, profile=profile,
                                   device="cpu"))
    if torch.distributed.get_rank() == 0:
        os.makedirs(b)
        shutil.copytree(os.path.join(a, "step_00000002"), os.path.join(b, "step_00000002"))
    torch.distributed.barrier()
    resumed = gather_state(train_loop(model, data, OPT, loop, b, mesh=mesh, profile=profile,
                                      device="cpu"))
    leaves = lambda st: {k: v.numpy() for k, v in _items(st)}
    return {"full": leaves(full), "resumed": leaves(resumed), "dir": a}


def _from_reference(mesh, ref_state):
    """5 sharded steps from the reference's initial state (numpy leaves)."""
    from repro_torch.convert import train_state_from_reference

    model = Model(fp32("qwen3-8b"))
    profile = default_profile(model.cfg, mesh)
    state = init_sharded_state(model, mesh, profile,
                               state=train_state_from_reference(ref_state, "cpu"))
    step, _, _ = make_train_step(model, OPT, mesh, profile)
    return _train(model, step, state)


def _worker(rank, world, init_file, out_file, args):
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    launch_dist.setup("cpu", init_method=f"file://{init_file}", rank=rank, world_size=world)
    out = _suite(*args)
    if rank == 0:
        torch.save(out, out_file)
    launch_dist.teardown()


def _start(tmp, mesh_key, ref_state=None):
    """The mesh's processes, started (joined by `_collect`)."""
    world = int(np.prod(MESHES[mesh_key][0]))
    return mp.start_processes(
        _worker, args=(world, os.path.join(tmp, f"pg-{mesh_key}"),
                       os.path.join(tmp, f"out-{mesh_key}.pt"), (mesh_key, tmp, ref_state)),
        nprocs=world, join=False, start_method="spawn")


def _collect(ctx, tmp, mesh_key):
    while not ctx.join():
        pass
    return torch.load(os.path.join(tmp, f"out-{mesh_key}.pt"), weights_only=False)


def _reference_start_and_losses():
    """The reference's initial state of fp32 reduced qwen3-8b (numpy) and
    its 5 losses from `make_train_step` on a one-device JAX mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro import configs as rconfigs
    from repro.models.config import ShardingProfile
    from repro.models.model import Model as RModel
    from repro.training.optimizer import AdamWConfig as RAdamW
    from repro.training.train_step import init_train_state as rinit, make_train_step as rstep

    cfg = dataclasses.replace(rconfigs.get_reduced_config("qwen3-8b"), dtype="float32")
    model = RModel(cfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    state = rinit(model, jax.random.key(0))
    start = jax.tree.map(np.asarray, state)
    step, _, _ = rstep(model, RAdamW(**dataclasses.asdict(OPT)), mesh, ShardingProfile(),
                       donate=False)
    data = SyntheticLMData(fp32("qwen3-8b"), batch=B, seq=S, seed=1)
    losses = []
    for k in range(STEPS):
        state, m = step(state, {k2: jnp.asarray(v) for k2, v in data(k).items()})
        losses.append(float(m["loss"]))
    return start, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = str(tmp_path_factory.mktemp("lm-mesh"))
    start, ref_losses = _reference_start_and_losses()
    # both meshes' processes run while this one computes the single-process runs
    ctxs = {key: _start(tmp, key, start if key == "2" else None) for key in MESHES}
    single = {}
    for arch in ARCHS:
        model = Model(fp32(arch))
        state = init_train_state(model, torch.Generator().manual_seed(0), device="cpu")
        data = SyntheticLMData(model.cfg, batch=B, seq=S, seed=1)
        _, grads = value_and_grad(model, state.params, batch_to_device(data(0), "cpu"))
        step, _, _ = make_train_step(model, OPT)
        params = model.init(torch.Generator().manual_seed(0))
        single[arch] = {
            "grads": {k: g.numpy() for k, g in _items(grads)},
            "losses": _train(model, step, state),
            "serve": _serve(model, params, model.prefill, model.decode_step, lambda x: x),
        }
    single["micro"] = _micro()
    got = {key: _collect(ctx, tmp, key) for key, ctx in ctxs.items()}
    return got, single, ref_losses


CASES = [(a, m) for m in MESHES for a in ARCHS]


@pytest.mark.parametrize("arch,mesh", CASES + [("qwen3-8b-fsdp", "2x2")])
def test_sharded_train_losses_match_single_process(runs, arch, mesh):
    got, single, _ = runs
    want = single[arch.removesuffix("-fsdp")]["losses"]
    have = got[mesh][arch]["losses"]
    np.testing.assert_allclose([l for l, _ in have], [l for l, _ in want], rtol=1e-4)
    np.testing.assert_allclose([g for _, g in have], [g for _, g in want], rtol=1e-4)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_grads_match_single_process(runs, arch, mesh):
    got, single, _ = runs
    have, want = got[mesh][arch]["grads"], single[arch]["grads"]
    assert sorted(have) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(have[k], w, atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("arch,mesh", CASES + [("qwen3-8b-fsdp", "2x2")])
def test_local_shards_follow_the_rules(runs, arch, mesh):
    assert runs[0][mesh][arch]["shapes_ok"]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_serve_fns_match_single_process(runs, arch, mesh):
    got, single, _ = runs
    for have, want in zip(got[mesh][arch]["serve"], single[arch]["serve"]):
        np.testing.assert_allclose(have, want, atol=1e-5, rtol=0)


def test_sharded_microbatched_step_matches_single_process(runs):
    got, single, _ = runs
    np.testing.assert_allclose(got["2"]["micro"], single["micro"], rtol=1e-4)


def test_mesh_loop_checkpoint_restores_and_resumes_bitwise(runs):
    loop = runs[0]["2"]["loop"]
    assert sorted(loop["full"]) == sorted(loop["resumed"])
    for k, v in loop["full"].items():
        assert np.array_equal(loop["resumed"][k], v), k
    # the checkpoint holds full tensors: one process reads the final state
    model = Model(fp32("qwen3-8b"))
    template = init_train_state(model, device="cpu")
    restored = CheckpointManager(loop["dir"]).restore(4, template, device="cpu")
    for k, v in _items(restored):
        assert np.array_equal(v.numpy(), loop["full"][k]), k


def test_sharded_step_matches_reference_mesh_step(runs):
    got, _, ref_losses = runs
    have = [l for l, _ in got["2"]["reference"]]
    np.testing.assert_allclose(have, ref_losses, rtol=1e-4)
