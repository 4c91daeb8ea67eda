"""Port parity: the drift meter of `service.session` against the JAX package.

  * `_edge_drift_device`, the form a session on a card runs, here on CPU
    tensors, against the reference's `_edge_drift` at rtol 1e-12 (the same
    float64 parts, summed in another order), with ||x_t|| against numpy's
    norm, over key sets that exercise every branch of the search: a few
    inserts and deletes, identical keys, an empty previous or current set,
    every edge new (disjoint keys, interleaved), every edge gone (the
    current keys all below or above the previous ones).
  * The numpy `_edge_drift`, a CPU session's form, bitwise the reference's.
  * Both forms' (matched, new, gone) counts against numpy's set operations.
  * `drift_edges_total{kind}` on a CPU scheduler: a cadence's inserts count
    as `new`, its deletes as `gone`, every other edge as `matched`.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from repro.service.session import _edge_drift as jax_edge_drift
from repro_torch import telemetry
from repro_torch.core import MaximizerConfig
from repro_torch.instances import InstanceDelta, MatchingInstanceSpec, generate_matching_instance
from repro_torch.service import Scheduler, ServiceConfig
from repro_torch.service.session import _edge_drift, _edge_drift_device


def _keys(rng, n, lo=0, hi=10**9):
    return np.unique(rng.integers(lo, hi, n)).astype(np.int64)


def _case(name, rng):
    """(prev, cur) as (sorted int64 keys, float64 values) pairs."""
    pk = _keys(rng, 5000, 10**6, 10**9)
    px = rng.uniform(0.0, 1.0, pk.size)
    if name == "inserts_deletes":
        keep = np.ones(pk.size, bool)
        keep[rng.choice(pk.size, 7, replace=False)] = False
        ins = np.setdiff1d(_keys(rng, 5, 10**6, 10**9), pk)
        ck = np.union1d(pk[keep], ins)
    elif name == "identical":
        ck = pk.copy()
    elif name == "empty_prev":
        pk, px, ck = pk[:0], px[:0], pk
    elif name == "empty_cur":
        ck = pk[:0]
    elif name == "every_edge_new":
        pk = pk * 2
        ck = np.union1d(pk[::2] + 1, pk[1::3] + 1)
    elif name == "every_edge_gone":
        ck = np.concatenate([_keys(rng, 40, 0, 10**6), _keys(rng, 60, 10**9 + 1, 2 * 10**9)])
    else:
        raise ValueError(name)
    cx = rng.uniform(0.0, 1.0, ck.size)
    # the edges that stay drift a little, as a warm cadence's do
    both = np.isin(ck, pk)
    cx[both] = px[np.searchsorted(pk, ck[both])] + rng.normal(0.0, 1e-3, both.sum())
    return (pk, px), (ck, cx)


CASES = ["inserts_deletes", "identical", "empty_prev", "empty_cur", "every_edge_new",
         "every_edge_gone"]


@pytest.mark.parametrize("name", CASES)
def test_device_form_matches_reference(name):
    prev, cur = _case(name, np.random.default_rng(CASES.index(name)))
    want = jax_edge_drift(prev, cur)
    drift, counts = _edge_drift(prev, cur)
    assert drift == want  # a CPU session's numbers, bit for bit
    to_t = lambda pair: tuple(torch.from_numpy(a.copy()) for a in pair)  # noqa: E731
    drift_d, x_norm, counts_d = _edge_drift_device(to_t(prev), to_t(cur))
    np.testing.assert_allclose(drift_d, want, rtol=1e-12)
    np.testing.assert_allclose(x_norm, np.linalg.norm(cur[1]), rtol=1e-12)
    matched = np.intersect1d(prev[0], cur[0]).size
    expected = (matched, cur[0].size - matched, prev[0].size - matched)
    assert counts == counts_d == expected
    if name != "identical":
        assert expected[1] + expected[2] > 0


@pytest.fixture
def fresh_registry():
    prev = telemetry.set_registry(telemetry.MetricsRegistry())
    yield telemetry.get_registry()
    telemetry.set_registry(prev)


def test_drift_edges_counter_counts_inserts_and_deletes(fresh_registry):
    """Two cadences of a CPU scheduler: the second's delta inserts 3 edges
    and deletes 2, so its drift counts 3 new, 2 gone and the rest matched."""
    spec = MatchingInstanceSpec(num_sources=200, num_destinations=12, avg_degree=4.0, seed=3)
    base = generate_matching_instance(spec)
    sched = Scheduler(ServiceConfig(cold=MaximizerConfig(iters_per_stage=30),
                                    warm_gammas=(0.1,), row_headroom=4), device="cpu")
    sched.add_tenant("t0", base)
    sched.run_cadence()
    assert fresh_registry.counter_total("drift_edges_total") == 0  # nothing to compare yet
    J = spec.num_destinations
    existing = set((base.src * J + base.dst).tolist())
    ins = [k for k in range(spec.num_sources * J) if k not in existing][5:8]
    dele = [0, 17]
    delta = InstanceDelta(
        insert_src=[k // J for k in ins], insert_dst=[k % J for k in ins],
        insert_values=[1.0, 2.0, 0.5], insert_coeff=np.ones((spec.num_families, 3)),
        delete_src=base.src[dele], delete_dst=base.dst[dele],
        update_src=base.src[40:60], update_dst=base.dst[40:60],
        update_values=base.values[40:60] * 1.05)
    report = sched.run_cadence({"t0": delta}).reports["t0"]
    assert report["drift_l2"] is not None
    reg = fresh_registry
    assert reg.counter_value("drift_edges_total", kind="new") == 3
    assert reg.counter_value("drift_edges_total", kind="gone") == 2
    assert reg.counter_value("drift_edges_total", kind="matched") == base.nnz - 2
