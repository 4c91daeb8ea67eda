"""Port parity: projection operators and their derivative, against the JAX package.

Values within atol 3e-5 (the reference's kernel tolerance,
tests/test_kernels.py); the autograd gradient of `project_simplex` against
the VJP of the reference's custom JVP within atol 1e-5.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import projections as jp
from repro_torch.core import projections as tp


def _inputs(seed, n=23, L=16, scale=2.0, keep=0.7, dead_rows=3):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(n, L)) * scale).astype(np.float32)
    mask = (rng.random((n, L)) < keep).astype(np.float32)
    mask[:dead_rows] = 0.0  # fully padded rows
    return v, mask


@pytest.mark.parametrize("inequality", [True, False])
@pytest.mark.parametrize("radius", [1.0, 2.5, 0.3])
@pytest.mark.parametrize("L", [1, 8, 64])
def test_project_simplex_matches(inequality, radius, L):
    v, mask = _inputs(L * 7 + int(radius * 10), L=L)
    got = tp.project_simplex(
        torch.from_numpy(v), torch.from_numpy(mask), radius, inequality=inequality
    )
    want = jp.project_simplex(
        jnp.asarray(v), jnp.asarray(mask), radius, inequality=inequality
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    assert float(got[:3].abs().max()) == 0.0  # padded rows exactly zero


@pytest.mark.parametrize("inequality", [True, False])
def test_project_simplex_per_row_radius(inequality):
    v, mask = _inputs(9)
    r = np.linspace(0.2, 3.0, v.shape[0]).astype(np.float32)
    got = tp.project_simplex(
        torch.from_numpy(v), torch.from_numpy(mask), torch.from_numpy(r),
        inequality=inequality,
    )
    want = jp.project_simplex(
        jnp.asarray(v), jnp.asarray(mask), jnp.asarray(r), inequality=inequality
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("inequality", [True, False])
def test_project_simplex_gradient_matches_jvp(inequality):
    # scale 0.3 leaves some rows feasible (inequality's identity branch)
    v, mask = _inputs(4, scale=0.3 if inequality else 2.0)
    w = np.random.default_rng(1).normal(size=v.shape).astype(np.float32)
    vt = torch.from_numpy(v).requires_grad_(True)
    (tp.project_simplex(vt, torch.from_numpy(mask), inequality=inequality)
     * torch.from_numpy(w)).sum().backward()
    _, vjp = jax.vjp(
        lambda x: jp.project_simplex(x, jnp.asarray(mask), inequality=inequality),
        jnp.asarray(v),
    )
    (want,) = vjp(jnp.asarray(w))
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want), atol=1e-5)
    # the Jacobian is symmetric, so the backward applied to a direction dv
    # equals the reference's forward-mode derivative along dv
    dv = np.random.default_rng(2).normal(size=v.shape).astype(np.float32)
    _, jvp = jax.jvp(
        lambda x: jp.project_simplex(x, jnp.asarray(mask), inequality=inequality),
        (jnp.asarray(v),), (jnp.asarray(dv),),
    )
    vt = torch.from_numpy(v).requires_grad_(True)
    (tp.project_simplex(vt, torch.from_numpy(mask), inequality=inequality)
     * torch.from_numpy(dv)).sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jvp), atol=1e-5)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 0.25)])
def test_project_box_matches(lo, hi):
    v, mask = _inputs(12)
    got = tp.project_box(torch.from_numpy(v), torch.from_numpy(mask), lo, hi)
    want = jp.project_box(jnp.asarray(v), jnp.asarray(mask), lo, hi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("radius", [0.5, 1.0, 4.0])
def test_project_box_cut_matches(radius):
    v, mask = _inputs(13)
    got = tp.project_box_cut(
        torch.from_numpy(v), torch.from_numpy(mask), 0.0, 0.8, radius, iters=40
    )
    want = jp.project_box_cut(
        jnp.asarray(v), jnp.asarray(mask), 0.0, 0.8, radius, iters=40
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.UnitSimplexProjection(radius=1.5, inequality=False),
        lambda m: m.BoxProjection(lo=0.0, hi=0.5),
        lambda m: m.BoxCutProjection(lo=0.0, hi=0.6, radius=1.2, iters=30),
    ],
)
def test_projection_maps_match(make):
    v, mask = _inputs(21)
    got = make(tp)(torch.from_numpy(v), torch.from_numpy(mask))
    want = make(jp)(jnp.asarray(v), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
