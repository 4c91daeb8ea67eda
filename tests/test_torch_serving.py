"""Port parity: allocation serving (`repro_torch.serving`) against its own
direct projection and against the JAX package.

The reference tests' instance (120 sources x 10 destinations, degree 4,
`row_headroom=4`).

  * For all four formulation presets, served batches (every live user,
    subsets, repeats, q = 1) are bitwise the port's own
    `direct_allocations` of the snapshot (the unfused full-slab projection):
    a simplex tenant through kernel 2's row-list entry (on the CPU its plain
    version), the other presets through the plain ops over the gathered
    rows.
  * The same JAX snapshot carried over by `convert.snapshot_from_reference`
    and served by both packages: x within atol 1e-6, rtol 1e-5, the same
    idx, mask and unmatched users.  The snapshot is published at gamma 1:
    the two packages' projections scan a row's sorted candidates in
    different orders (XLA's cumsum against PyTorch's), so x differs by an
    ulp of the candidate -(A'lam + c)/gamma, which grows as 1/gamma: 1.7e-7
    at gamma 1, 1.5e-5 at the service's floor of 0.01 (ROADMAP, Queue 3).
  * Range validation and unmatched users; the session's publication and
    the store's history; the generation fence under the port's
    `run_pipeline` (queries hammering the store from a thread while the
    solver thread runs), each batch bitwise the direct projection of the
    generation it reports; the serve CLI on the CPU.
"""
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro import service as jsvc
from repro import serving as jserving
from repro.formulation import scenario_formulation as jax_scenario
from repro.instances import DeltaIngestor as JaxIngestor
from repro_torch import convert
from repro_torch.core import MaximizerConfig
from repro_torch.formulation import scenario_formulation
from repro_torch.instances import (
    DeltaIngestor,
    InstanceDelta,
    MatchingInstanceSpec,
    generate_matching_instance,
)
from repro_torch.service import (
    Scheduler,
    ServiceConfig,
    SolveSession,
    compiled_solver,
    device_put_instance,
    to_solve_result,
)
from repro_torch.serving import DualStore, direct_allocations

from test_torch_service import BASE, BASE_J, COLD, SERVICE, _perturb  # noqa: F401

PRESETS = ("matching", "capacity-cap", "fairness-floor", "budget-pacing")
CFG = MaximizerConfig(iters_per_stage=60)


def _published(preset: str, store: DualStore):
    """One preset solved by the normalized engine solver and published."""
    ing = DeltaIngestor(BASE, row_headroom=4)
    comp = scenario_formulation(preset).compile(ing.instance())
    dev = device_put_instance(comp.instance, "cpu")
    res = to_solve_result(compiled_solver(CFG, True)(dev, torch.zeros(dev.dual_dim)))
    return store.publish_result(
        preset, dev, res.lam, generation=ing.generation, gamma=CFG.gammas[-1],
        bucket_of=ing.bucket_of, row_of=ing.row_of, deg=ing.deg, normalize=True)


def _assert_bitwise(result, snap):
    xs = [x.numpy() for x in direct_allocations(snap)]
    for ba in result.slabs:
        ref = xs[ba.bucket][ba.rows]
        assert ba.x.dtype == ref.dtype and np.array_equal(ba.x, ref), ba.bucket
        inst_b = snap.instance.buckets[ba.bucket]
        assert np.array_equal(ba.idx, inst_b.idx.numpy()[ba.rows])
        assert np.array_equal(ba.mask, inst_b.mask.float().numpy()[ba.rows])


@pytest.mark.parametrize("preset", PRESETS)
def test_query_matches_direct_projection_bitwise(preset):
    store = DualStore()
    snap = _published(preset, store)
    assert snap.query_route()["kernel"] == (preset == "matching")
    users = np.flatnonzero(snap.deg > 0)
    result = store.query(preset, users)
    assert result.generation == snap.generation and result.unmatched.size == 0
    _assert_bitwise(result, snap)
    rng = np.random.default_rng(3)
    for size in (1, 2, 7, 33):
        batch = rng.choice(users, size=size, replace=True)  # repeats included
        _assert_bitwise(store.query(preset, batch), snap)


@pytest.mark.parametrize("preset", ("matching", "capacity-cap"))
def test_reference_snapshot_served_by_both_packages(preset):
    """A JAX snapshot carried over by `convert.snapshot_from_reference`:
    both stores serve the same users alike."""
    store_j = jserving.DualStore()
    ing = JaxIngestor(BASE_J, row_headroom=4)
    comp = jax_scenario(preset).compile(ing.instance())
    dev = jsvc.device_put_instance(comp.instance)
    from repro.core import MaximizerConfig as JaxConfig

    cfg = JaxConfig(iters_per_stage=60, gammas=(1e3, 1e2, 10.0, 1.0))
    res = jsvc.to_solve_result(jsvc.compiled_solver(cfg, True)(
        dev, jnp.zeros(dev.dual_dim, jnp.float32)))
    snap_j = store_j.publish_result(
        preset, dev, res.lam, generation=ing.generation, gamma=cfg.gammas[-1],
        bucket_of=ing.bucket_of, row_of=ing.row_of, deg=ing.deg, normalize=True)
    snap = convert.snapshot_from_reference(snap_j, "cpu")
    store = DualStore()
    store.publish(snap)
    rng = np.random.default_rng(4)
    users = rng.choice(snap.num_users, size=64, replace=True)
    got, want = store.query(preset, users), store_j.query(preset, users)
    assert got.generation == want.generation
    np.testing.assert_array_equal(np.sort(got.unmatched), np.sort(want.unmatched))
    assert [ba.bucket for ba in got.slabs] == [ba.bucket for ba in want.slabs]
    for a, b in zip(got.slabs, want.slabs):
        np.testing.assert_array_equal(a.users, b.users)
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.idx, np.asarray(b.idx))
        np.testing.assert_array_equal(a.mask, np.asarray(b.mask, np.float32))
        np.testing.assert_allclose(a.x, np.asarray(b.x), atol=1e-6, rtol=1e-5)
    _assert_bitwise(got, snap)


def test_unmatched_users_and_range_validation():
    store = DualStore()
    snap = _published("matching", store)
    dead = np.flatnonzero(snap.deg == 0)
    live = np.flatnonzero(snap.deg > 0)[:4]
    assert dead.size
    result = store.query("matching", np.concatenate([live, dead[:2]]))
    assert set(result.unmatched) == set(dead[:2])
    ids, x = result.allocation(int(dead[0]))
    assert ids.size == 0 and x.size == 0
    for u in live:
        ids, x = result.allocation(int(u))
        assert ids.size == int(snap.deg[u])
        assert np.all(x >= 0.0) and float(x.sum()) <= 1.0 + 1e-5
    with pytest.raises(ValueError):
        store.query("matching", [snap.num_users])
    with pytest.raises(ValueError):
        store.query("matching", [-1])
    with pytest.raises(KeyError):
        store.query("no-such-tenant", [0])
    assert store.query("matching", []).num_users == 0


def test_session_publishes_and_history_answers():
    rng = np.random.default_rng(5)
    store = DualStore(history=4)
    sess = SolveSession("t0", BASE, ServiceConfig(cold=MaximizerConfig(**COLD), **SERVICE),
                        device="cpu")
    sess.dual_store = store
    _, rep0 = sess.solve()
    assert rep0["published_generation"] == 0
    snap0 = store.snapshot("t0")
    users = np.flatnonzero(snap0.deg > 0)
    _assert_bitwise(store.query("t0", users), snap0)
    sess.ingest(InstanceDelta(**_perturb(BASE, rng)))
    _, rep1 = sess.solve()
    assert rep1["published_generation"] == sess.ingestor.generation > 0
    snap1 = store.snapshot("t0")
    _assert_bitwise(store.query("t0", users), snap1)
    _assert_bitwise(store.query_snapshot(store.get("t0", 0), users), snap0)
    assert store.generations("t0") == [0, snap1.generation]


def test_generation_fence_under_pipeline():
    """Queries hammering the store from two threads while the port's
    run_pipeline swaps snapshots (solver thread and ingest, a shortened GIL
    switch interval): every batch is answered against ONE retained
    generation and is bitwise its direct projection."""
    import sys

    rng = np.random.default_rng(9)
    store = DualStore(history=16)
    sched = Scheduler(ServiceConfig(cold=MaximizerConfig(**COLD), **SERVICE),
                      dual_store=store, device="cpu")
    base2 = generate_matching_instance(MatchingInstanceSpec(
        num_sources=120, num_destinations=10, avg_degree=4.0, seed=22))
    sched.add_tenant("t0", BASE)
    sched.add_tenant("t1", base2)
    sched.run_cadence()
    deltas = [{"t0": InstanceDelta(**_perturb(BASE, rng)),
               "t1": InstanceDelta(**_perturb(base2, rng))} for _ in range(3)]
    users = np.flatnonzero(store.snapshot("t0").deg > 0)
    results, stop = [], threading.Event()

    def hammer():
        qrng = np.random.default_rng(threading.get_ident() % 2**32)
        while not stop.is_set():
            results.append(store.query("t0", qrng.choice(users, size=24, replace=False)))

    workers = [threading.Thread(target=hammer, daemon=True) for _ in range(2)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for w in workers:
            w.start()
        outs = sched.run_pipeline(deltas)
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=30)
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    assert len(outs) == 3 and all(not o.ingest_errors for o in outs)
    gens = {r.generation for r in results}
    assert len(gens) >= 2, "the hammer should observe a mid-pipeline swap"
    assert gens <= set(store.generations("t0"))
    for r in results:
        _assert_bitwise(r, store.get("t0", r.generation))


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--sources", "200", "--destinations", "10",
                       "--cadences", "2", "--iters-per-stage", "40", "--verify"]) == 0
    assert "all bit-identical" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--sources", "50", "--destinations", "5"])
