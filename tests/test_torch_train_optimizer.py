"""The port's AdamW (`repro_torch.training.optimizer`) against the JAX
package's.

`adamw_update` is fed identical numpy grads in both packages (a step's own
gradients differ in the last bits between packages, and AdamW's first step
is close to a sign function, so params after steps from each package's own
gradients are not comparable): params, moments, count, grad norm and lr
over several steps, clipped and unclipped, at atol 1e-6.  The in-place form
(`adamw_update_`, what the donating train step runs) is bit-equal to the
functional one.  Then the reference's own optimizer tests
(tests/test_training.py) on the port.
"""
import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.training import optimizer as R  # noqa: E402
from repro_torch.training import optimizer as T  # noqa: E402

SHAPES = {"w": (16, 8), "blocks": {"ln": (2, 8), "w": (2, 8, 4, 3)}, "prefix": [(5,), (3, 7)]}


def tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: tree(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [tree(rng, v, scale) for v in shapes]
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def tt(t):
    """A numpy tree as fresh CPU tensors."""
    return T.tree_map(lambda a: torch.from_numpy(a.copy()), t)


def rleaves(t):
    return [np.asarray(x) for x in jax.tree.leaves(t)]


def pleaves(t):
    return [x.numpy() for x in T.tree_leaves(t)]


@pytest.mark.parametrize("clip_norm", [0.5, 1e9])
def test_adamw_matches_reference_on_identical_grads(clip_norm):
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip_norm)
    p = tree(rng)
    rp = jax.tree.map(jnp.asarray, p)
    rs = R.adamw_init(rp)
    tp, tp_ = tt(p), tt(p)
    ts, ts_ = T.adamw_init(tp), T.adamw_init(tp_)
    rupd = jax.jit(lambda g, s, p: R.adamw_update(R.AdamWConfig(**cfg), g, s, p))
    for _ in range(6):
        g = tree(rng, scale=3.0)
        rp, rs, rm = rupd(jax.tree.map(jnp.asarray, g), rs, rp)
        keep = tt(g)
        tp, ts, tm = T.adamw_update(T.AdamWConfig(**cfg), keep, ts, tp)
        tp_, ts_, tm_ = T.adamw_update_(T.AdamWConfig(**cfg), tt(g), ts_, tp_)
        # the functional form left its grads alone
        for a, b in zip(pleaves(keep), [x for x in jax.tree.leaves(g)]):
            np.testing.assert_array_equal(a, b)
        for name, want, got in (("params", rp, tp), ("m", rs.m, ts.m), ("v", rs.v, ts.v)):
            for a, b in zip(pleaves(got), rleaves(want)):
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=name)
        assert int(ts.count) == int(rs.count) and ts.count.dtype == torch.int32
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6)
        # in place: the same bits, in the same tensors
        for a, b in zip(T.tree_leaves([tp, ts.m, ts.v]), T.tree_leaves([tp_, ts_.m, ts_.v])):
            assert torch.equal(a, b)
        assert torch.equal(tm["grad_norm"], tm_["grad_norm"]) and torch.equal(tm["lr"], tm_["lr"])
        assert int(ts_.count) == int(ts.count)


def test_adamw_in_place_updates_the_given_tensors():
    rng = np.random.default_rng(1)
    p = tt(tree(rng))
    st = T.adamw_init(p)
    ids = [x.data_ptr() for x in T.tree_leaves([p, st.m, st.v])] + [st.count.data_ptr()]
    before = [x.clone() for x in T.tree_leaves(p)]
    p2, st2, _ = T.adamw_update_(T.AdamWConfig(warmup_steps=0), tt(tree(rng)), st, p)
    assert [x.data_ptr() for x in T.tree_leaves([p2, st2.m, st2.v])] + [st2.count.data_ptr()] == ids
    assert int(st.count) == 1
    assert all(not torch.equal(a, b) for a, b in zip(before, T.tree_leaves(p)))


def test_lr_schedule_matches_reference():
    for kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
               dict(lr=3e-4, warmup_steps=0, total_steps=7, min_lr_ratio=0.0)):
        for s in range(0, 120, 3):
            want = float(R.lr_schedule(R.AdamWConfig(**kw), jnp.asarray(s, jnp.int32)))
            got = float(T.lr_schedule(T.AdamWConfig(**kw), torch.tensor(s, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_lr_schedule_shape():
    cfg = T.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(T.lr_schedule(cfg, torch.tensor(s))) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4, rel=1e-3)
    assert lrs[2] == pytest.approx(1e-3, rel=1e-3)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=1e-2)


def test_grad_clip():
    params = {"w": torch.ones((4,))}
    grads = {"w": torch.full((4,), 100.0)}
    cfg = T.AdamWConfig(clip_norm=1.0, lr=1.0, weight_decay=0.0, warmup_steps=0)
    for update in (T.adamw_update, T.adamw_update_):
        p = {"w": params["w"].clone()}
        _, _, metrics = update(cfg, {"w": grads["w"].clone()}, T.adamw_init(p), p)
        assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_global_norm_no_ravel():
    """global_norm sums each leaf over its own dims, as the reference's:
    no flattening of a leaf (tests/test_training.py)."""
    src = inspect.getsource(T.global_norm)
    code = "\n".join(
        ln.split("#")[0] for ln in src.splitlines() if not ln.strip().startswith("#")
    )
    for bad in ("vdot(", "ravel(", "flatten(", "view(-1", "reshape(-1", "dot("):
        assert bad not in code, bad
    rng = np.random.default_rng(2)
    g = tree(rng)
    np.testing.assert_allclose(float(T.global_norm(tt(g))),
                               float(R.global_norm(jax.tree.map(jnp.asarray, g))), rtol=1e-6)


def test_adamw_matches_hand_rolled_numpy():
    """One AdamW step against a hand-rolled numpy version (the reference's
    tests/test_training.py::test_adamw_matches_reference), both forms."""
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(3, 2)).astype(np.float32)}
    g = {"a": rng.normal(size=(3, 2)).astype(np.float32)}
    cfg = T.AdamWConfig(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                        clip_norm=1e9, warmup_steps=0, total_steps=1, min_lr_ratio=1.0)
    m = 0.1 * g["a"]
    v = 0.05 * g["a"] ** 2
    mh, vh = m / 0.1, v / 0.05
    want = p["a"] - 1e-2 * (mh / (np.sqrt(vh) + 1e-8) + 0.1 * p["a"])
    for update in (T.adamw_update, T.adamw_update_):
        tp = tt(p)
        p2, _, _ = update(cfg, tt(g), T.adamw_init(tp), tp)
        np.testing.assert_allclose(p2["a"].numpy(), want, atol=1e-6)
