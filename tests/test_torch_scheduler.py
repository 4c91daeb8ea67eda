"""Port parity: the multi-tenant scheduler (`service.scheduler`, with
`service.session`) against the JAX package, and its pipelined cadences.

The reference tests' instance (120 sources x 10 destinations, degree 4,
`row_headroom=4`), seeded numpy deltas given to both packages.

  * The scheduler against the reference's on the same cadences: grouping,
    report keys, modes, iterations, and the drift values at rtol 1e-4 (as in
    `tests/test_torch_stability.py`).
  * `run_pipeline` (the solver thread) against a `run_cadence` loop, report
    for report; a delta rejected mid-overlap leaking nothing; an error on
    the solver thread reaching the caller.
  * Sigma reuse on a quiet warm cadence, and its invalidation by coefficient
    edits; the batched group's reuse.
  * The service CLI on the CPU (`--verify`), and its refusal of the card's
    default device without a card.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from repro import service as jsvc
from repro.instances import InstanceDelta as JaxDelta
from repro_torch import telemetry
from repro_torch.instances import InstanceDelta
from repro_torch.service import BatchedSolvePool, Scheduler, SolveSession

from test_torch_service import (  # noqa: F401  (fixtures)
    BASE,
    BASE_J,
    _jax_service,
    _perturb,
    _service,
    fresh_telemetry,
    jax_start_vector,
)


def _cadence_deltas(rng, sessions_el, frac=0.1):
    return {name: _perturb(el, rng, frac) for name, el in sessions_el.items()}


def test_scheduler_matches_reference(jax_start_vector):
    """Two cadences of a 4-tenant fleet in both packages: the same groups,
    report keys, modes and iterations; g at rtol 1e-5, the drift values at
    rtol 1e-4.  Fixed-budget stages (no early stop): with 4 identical
    tenants the early-stop test flips at some check on this instance, as
    in the pool test above.  The warm tail ends at gamma 0.1: lam agrees to
    ~1e-5 across packages and x = Pi(-(A'lam + c)/gamma) multiplies that by
    1/gamma, so at a 0.01 floor the drift values (differences of two close
    primals) agree only to 1.3e-4 (ROADMAP, Queue 3); at 0.1 to 2.5e-5."""
    kw = dict(cold=dict(iters_per_stage=60), warm_gammas=(1.0, 0.1))
    sched = Scheduler(_service(**kw), device="cpu")
    sched_j = jsvc.Scheduler(_jax_service(**kw))
    for t in range(4):
        sched.add_tenant(f"t{t}", BASE)
        sched_j.add_tenant(f"t{t}", BASE_J)
    rng = np.random.default_rng(11)
    for cadence in range(2):
        deltas = (_cadence_deltas(rng, {n: s.ingestor.to_edge_list()
                                        for n, s in sched_j.sessions.items()})
                  if cadence else {})
        out = sched.run_cadence({n: InstanceDelta(**d) for n, d in deltas.items()})
        out_j = sched_j.run_cadence({n: JaxDelta(**d) for n, d in deltas.items()})
        assert out.batched_groups == out_j.batched_groups
        assert out.solo_tenants == out_j.solo_tenants
        for name, r in out.reports.items():
            rj = out_j.reports[name]
            assert set(r) == set(rj), name
            for k in ("mode", "cold_reason", "batched", "engine", "iters_used",
                      "iter_budget", "warm_schedule", "warm_level", "upload_mode",
                      "upload_bytes", "sigma_reused", "sla_ok", "cadence"):
                assert r[k] == rj[k], (cadence, name, k)
            np.testing.assert_allclose(r["g"], rj["g"], rtol=1e-5)
            np.testing.assert_allclose(r["dc_norm"], rj["dc_norm"], rtol=1e-6)
            for k in ("drift_l2", "drift_rel", "drift_bound"):
                if rj[k] is None:
                    assert r[k] is None
                else:
                    np.testing.assert_allclose(r[k], rj[k], rtol=1e-4, err_msg=k)
            assert set(r["convergence"]) == set(rj["convergence"])
    assert out.batched_fraction == 1.0 and out.upload_bytes == out_j.upload_bytes


def _fresh(n=4):
    sched = Scheduler(_service(), device="cpu")
    for t in range(n):
        sched.add_tenant(f"t{t}", BASE)
    return sched


def _pipeline_deltas(cadences=2, seed=43):
    out = [None]
    for c in range(cadences):
        rng = np.random.default_rng(seed + c)
        out.append({f"t{t}": InstanceDelta(**_perturb(BASE, rng)) for t in range(4)})
    return out


def test_pipeline_matches_sequential_cadences():
    """run_pipeline (solves on the solver thread, the next ingest overlapped)
    == a run_cadence loop, report for report."""
    deltas = _pipeline_deltas()
    outs_p = _fresh().run_pipeline(deltas)
    sched_s = _fresh()
    outs_s = [sched_s.run_cadence(d) for d in deltas]
    assert outs_p[1].overlapped and outs_p[2].overlapped
    for op, os_ in zip(outs_p, outs_s):
        assert not op.ingest_errors
        assert op.batched_groups == os_.batched_groups
        for name in op.reports:
            for k in ("g", "mode", "iters_used", "dc_norm", "drift_bound", "drift_rel"):
                assert op.reports[name][k] == os_.reports[name][k], (name, k)
    reg = telemetry.get_registry()
    assert 0.0 <= reg.gauge_value("scheduler_overlap_efficiency") <= 1.0


def test_rejected_delta_mid_overlap_leaks_nothing():
    J = BASE.spec.num_destinations
    s0 = int(BASE.src[0])
    missing = next(d for d in range(J) if d not in set(BASE.dst[BASE.src == s0].tolist()))
    good = _pipeline_deltas(cadences=1, seed=47)[1]
    bad = InstanceDelta(delete_src=[int(BASE.src[1]), s0],
                        delete_dst=[int(BASE.dst[1]), missing])
    sched = _fresh()
    outs = sched.run_pipeline([None, {**good, "t0": bad}])
    assert "not present" in outs[1].ingest_errors["t0"]
    assert sched.sessions["t0"].ingestor.generation == 0
    ref = _fresh().run_pipeline([None, {k: v for k, v in good.items() if k != "t0"}])
    assert outs[1].reports["t0"]["g"] == ref[1].reports["t0"]["g"]
    for t in ("t1", "t2", "t3"):
        assert t in outs[1].ingest
        assert outs[1].reports[t]["g"] == ref[1].reports[t]["g"]


def test_solver_thread_errors_reach_the_caller(monkeypatch):
    """A solve that raises on the solver thread raises at the fence."""
    sched = _fresh(2)

    def broken(*a, **k):
        raise RuntimeError("solver broke")

    monkeypatch.setattr(BatchedSolvePool, "solve_async", broken)
    with pytest.raises(RuntimeError, match="solver broke"):
        sched.run_pipeline([None])


def test_sigma_reuse_and_invalidation():
    """A quiet warm cadence reuses sigma^2 (same quality); a coefficient
    edit dirties it, a later cost-only edit makes it reusable again; the
    batched group reuses when every member is ready."""
    cfg = _service(sigma_reuse_dc_threshold=1e6)
    sess = SolveSession("t0", BASE, cfg, device="cpu")
    sess.solve()
    rng = np.random.default_rng(19)
    sess.ingest(InstanceDelta(**_perturb(BASE, rng, 0.05)))
    _, rep = sess.solve()
    assert rep["mode"] == "warm" and rep["sigma_reused"] is True
    sess.ingest(InstanceDelta(update_src=BASE.src[:1], update_dst=BASE.dst[:1],
                              update_coeff=np.asarray([[7.5]])))
    _, rep = sess.solve()
    assert rep["sigma_reused"] is False
    sess.ingest(InstanceDelta(update_src=BASE.src[:1], update_dst=BASE.dst[:1],
                              update_values=[float(BASE.values[0]) + 0.01]))
    _, rep = sess.solve()
    assert rep["sigma_reused"] is True
    sched = Scheduler(cfg, device="cpu")
    for t in range(2):
        sched.add_tenant(f"t{t}", BASE)
    sched.run_cadence()
    out = sched.run_cadence({f"t{t}": InstanceDelta(**_perturb(BASE, rng, 0.05))
                             for t in range(2)})
    assert out.batched_groups == [["t0", "t1"]]
    assert all(r["sigma_reused"] for r in out.reports.values())
    assert telemetry.get_registry().counter_total("pool_sigma_reuse_solves_total") == 2


def test_service_cli_on_the_cpu(capsys):
    from repro_torch.launch import service

    assert service.main(["--device", "cpu", "--sources", "200", "--destinations", "10",
                         "--tenants", "2", "--cadences", "2", "--iters-per-stage", "60",
                         "--fused-oracle", "--verify"]) == 0
    out = capsys.readouterr().out
    assert "VERIFY OK" in out and "batched 2/2 tenants in 1 batched call(s)" in out
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            service.main(["--sources", "50", "--destinations", "5", "--cadences", "1"])
