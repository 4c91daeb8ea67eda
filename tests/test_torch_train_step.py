"""The port's train step (`repro_torch.training.make_train_step`) against
the JAX package's training path.

* Microbatching: 4 microbatches of 2 against one batch of 8 on reduced
  gemma-7b, at the reference's 5e-3 (tests/test_training.py); and against
  the reference's own per-microbatch accumulation at 1e-5.
* `donate=True` (in place) against `donate=False` (new tensors): the same
  bits after three steps.
* A 10-step fp32 trajectory of reduced qwen3-8b from the reference's
  initial state (carried by `convert.train_state_from_reference`) against
  the reference's step: losses at rtol 1e-4.
* The reference's `test_loss_decreases` on the port: 40 steps.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RData  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro.training.optimizer import AdamWConfig as RAdamW, adamw_update as radamw  # noqa: E402
from repro.training.train_step import TrainState as RState, init_train_state as rinit  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.manager import _items  # noqa: E402
from repro_torch.convert import lm_params_from_reference, train_state_from_reference  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig, init_train_state, make_train_step, value_and_grad,
)
from repro_torch.training.loop import batch_to_device  # noqa: E402
from repro_torch.training.optimizer import tree_leaves, tree_map  # noqa: E402


def fp32(arch):
    return (dataclasses.replace(rconfigs.get_reduced_config(arch), dtype="float32"),
            dataclasses.replace(tconfigs.get_reduced_config(arch), dtype="float32"))


def test_microbatch_equivalence():
    """Mean of 4 microbatch grads == the batch's grads (every microbatch has
    the same number of valid labels), and == the reference's accumulation."""
    rc, tc = fp32("gemma-7b")
    rm = RModel(rc)
    rparams = rm.init(jax.random.key(0))
    data = RData(rc, batch=8, seq=16, seed=1)(0)
    model = Model(tc)
    params = lm_params_from_reference(jax.tree.map(np.asarray, rparams), "cpu")
    batch = batch_to_device(data, "cpu")
    _, g_full = value_and_grad(model, params, batch)

    micro = {k: v.reshape((4, 2) + v.shape[1:]) for k, v in data.items()}
    rgrad = jax.jit(jax.grad(rm.loss))
    r_acc = jax.tree.map(jnp.zeros_like, rparams)
    t_acc = tree_map(torch.zeros_like, params)
    for i in range(4):
        g = rgrad(rparams, {k: jnp.asarray(v[i]) for k, v in micro.items()})
        r_acc = jax.tree.map(lambda a, b: a + b / 4, r_acc, g)
        _, gt = value_and_grad(model, params, {k: torch.from_numpy(v[i]) for k, v in micro.items()})
        t_acc = tree_map(lambda a, b: a + b / 4, t_acc, gt)
    flat = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(r_acc)[0]}
    full, acc = dict(_items(g_full)), dict(_items(t_acc))
    assert sorted(acc) == sorted(flat)
    for k, want in flat.items():
        np.testing.assert_allclose(acc[k].numpy(), full[k].numpy(), atol=5e-3, err_msg=k)
        np.testing.assert_allclose(acc[k].numpy(), want, atol=1e-5, rtol=0, err_msg=k)


def test_microbatch_step_accumulates_in_the_reference_order():
    """make_train_step(microbatches=4)'s loss and update equal a hand-rolled
    accumulation followed by the functional AdamW, bit for bit."""
    from repro_torch.training import adamw_update

    _, tc = fp32("qwen3-8b")
    model = Model(tc)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    data = SyntheticLMData(tc, batch=8, seq=16, seed=2)(0)
    batch = batch_to_device(data, "cpu")
    state = init_train_state(model, device="cpu")
    step, _, _ = make_train_step(model, cfg, microbatches=4, donate=False)
    got, metrics = step(state, batch)
    loss = torch.zeros(())
    grads = tree_map(torch.zeros_like, state.params)
    for i in range(4):
        mb = {k: v.reshape((4, 2) + v.shape[1:])[i] for k, v in batch.items()}
        lt, gt = value_and_grad(model, state.params, mb)
        loss = loss + lt / 4
        grads = tree_map(lambda a, g: a + g / 4, grads, gt)
    want, _, _ = adamw_update(cfg, grads, state.opt, state.params)
    assert torch.equal(metrics["loss"], loss)
    for a, b in zip(tree_leaves(got.params), tree_leaves(want)):
        assert torch.equal(a, b)


def test_donated_step_equals_functional_step():
    _, tc = fp32("qwen3-8b")
    model = Model(tc)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    data = SyntheticLMData(tc, batch=4, seq=16, seed=0)
    s_don = init_train_state(model, device="cpu")
    s_fun = init_train_state(model, device="cpu")
    don, _, _ = make_train_step(model, cfg)
    fun, _, _ = make_train_step(model, cfg, donate=False)
    for k in range(3):
        b = batch_to_device(data(k), "cpu")
        ptrs = [x.data_ptr() for x in tree_leaves(s_don.params)]
        before = [x.clone() for x in tree_leaves(s_fun.params)]
        s_don, m_don = don(s_don, b)
        s_fun2, m_fun = fun(s_fun, b)
        # the functional step left its state alone; the donated one reused it
        assert all(torch.equal(a, x) for a, x in zip(before, tree_leaves(s_fun.params)))
        assert [x.data_ptr() for x in tree_leaves(s_don.params)] == ptrs
        s_fun = s_fun2
        assert torch.equal(m_don["loss"], m_fun["loss"])
        for a, x in zip(tree_leaves([s_don.params, s_don.opt.m, s_don.opt.v]),
                        tree_leaves([s_fun.params, s_fun.opt.m, s_fun.opt.v])):
            assert torch.equal(a, x)
        assert int(s_don.step) == int(s_fun.step) == k + 1 == int(s_don.opt.count)


def test_mesh_and_missing_card_are_refused():
    _, tc = fp32("qwen3-8b")
    with pytest.raises(ValueError, match="ShardingProfile"):
        make_train_step(Model(tc), AdamWConfig(), mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            init_train_state(Model(tc))


def test_trajectory_matches_reference():
    """10 steps from the reference's initial state, each package on its own
    gradients: losses at rtol 1e-4."""
    rc, tc = fp32("qwen3-8b")
    rm, model = RModel(rc), Model(tc)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    rcfg = RAdamW(**opt)
    rstate = rinit(rm, jax.random.key(0))
    state = train_state_from_reference(jax.tree.map(np.asarray, rstate), "cpu")

    @jax.jit
    def rstep(st, b):
        loss, grads = jax.value_and_grad(rm.loss)(st.params, b)
        p, o, _ = radamw(rcfg, grads, st.opt, st.params)
        return RState(p, o, st.step + 1), loss

    step, _, _ = make_train_step(model, AdamWConfig(**opt))
    data = RData(rc, batch=8, seq=32, seed=0)
    rl, tl = [], []
    for k in range(10):
        rstate, loss = rstep(rstate, {kk: jnp.asarray(v) for kk, v in data(k).items()})
        state, metrics = step(state, batch_to_device(data(k), "cpu"))
        rl.append(float(loss))
        tl.append(float(metrics["loss"]))
    np.testing.assert_allclose(tl, rl, rtol=1e-4)
    assert int(state.step) == 10


def test_loss_decreases():
    cfg = tconfigs.get_reduced_config("qwen3-8b")
    model = Model(cfg)
    data = SyntheticLMData(cfg, batch=8, seq=32, seed=0)
    state = init_train_state(model, device="cpu")
    step, _, _ = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40))
    losses = []
    for k in range(40):
        state, metrics = step(state, batch_to_device(data(k), "cpu"))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[:3] + losses[-3:]
