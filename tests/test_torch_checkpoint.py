"""Port parity: checkpointing (`repro_torch.checkpoint`) and the service's
checkpoints across packages.

  * The manager: an atomic write (a half-written `.tmp` directory is never
    a checkpoint), keep-K garbage collection, async writes then `wait`,
    template restore onto a device with shape checks, `restore_flat` and
    `read_meta`; the on-disk keys and manifest are the reference manager's
    for the same state.
  * A checkpoint written by the JAX `Scheduler` restores in the port's (its
    `ServiceConfig` carried by `convert.service_config_from_reference`), and
    one written by the port restores in the JAX one; in both directions the
    next cadence is warm, every tenant's restored state equals the saved
    one, and the reports carry the same keys and modes.
"""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from repro import service as jsvc
from repro import telemetry as jtel
from repro.checkpoint import CheckpointManager as JaxManager
from repro.instances import InstanceDelta as JaxDelta
from repro_torch import convert, telemetry
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.instances import InstanceDelta
from repro_torch.service import Scheduler

from test_torch_service import (  # noqa: F401  (fixtures)
    BASE,
    BASE_J,
    _jax_service,
    _perturb,
    _service,
    fresh_telemetry,
)


def _state():
    return {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "b": np.ones(3, np.float64)},
            "opt": [torch.zeros(2, dtype=torch.int64), np.asarray(7, np.int32)],
            "step": np.asarray(3)}


def test_roundtrip_and_format_matches_reference(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "port"), async_write=False)
    mgr.save(5, state, meta={"note": "x"})
    got = mgr.restore(5, state, device="cpu")
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert got["params"]["b"].dtype == torch.float64 and got["opt"][1].dtype == torch.int32
    assert mgr.read_meta(5) == {"note": "x"}
    # the reference's manager on the same state: the same keys and manifest
    jmgr = JaxManager(str(tmp_path / "jax"), async_write=False)
    jstate = jax.tree.map(lambda a: np.asarray(a), {
        "params": {"w": np.asarray(state["params"]["w"]), "b": state["params"]["b"]},
        "opt": [np.zeros(2, np.int64), state["opt"][1]], "step": state["step"]})
    jmgr.save(5, jstate, meta={"note": "x"})
    read = lambda root: json.load(open(os.path.join(root, "step_00000005", "manifest.json")))
    assert read(str(tmp_path / "port")) == read(str(tmp_path / "jax"))
    with np.load(tmp_path / "port" / "step_00000005" / "arrays.npz") as a, \
            np.load(tmp_path / "jax" / "step_00000005" / "arrays.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    # and each manager restores the other's
    back = jmgr.restore(5, jstate)
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]), state["params"]["w"].numpy())
    cross = CheckpointManager(str(tmp_path / "jax")).restore(5, state)
    assert torch.equal(cross["params"]["w"], state["params"]["w"])


def test_async_keep_k_and_half_written(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(4):
        mgr.save(step, _state())
    mgr.wait()
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_00000002", "step_00000003"]
    os.makedirs(tmp_path / "step_00000009.123-4.tmp")
    os.makedirs(tmp_path / "step_00000010")  # no manifest: never a checkpoint
    assert latest_step(str(tmp_path)) == 3
    assert latest_step(str(tmp_path / "absent")) is None


def test_shape_mismatch_rejected_and_restore_flat(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(0, {"a/b": np.arange(4.0), "c": np.zeros(2)}, meta={"k": 1})
    arrays, meta = mgr.restore_flat(0)
    assert set(arrays) == {"a/b", "c"} and meta == {"k": 1}
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(0, {"a/b": np.zeros(5), "c": np.zeros(2)})


def _cadence(sched, deltas, delta_cls):
    return sched.run_cadence({n: delta_cls(**d) for n, d in deltas.items()})


def _assert_same_sessions(port, ref):
    for name, s in port.sessions.items():
        sj = ref.sessions[name]
        np.testing.assert_array_equal(s.lam_prev.numpy(), np.asarray(sj.lam_prev))
        assert s.cadence == sj.cadence and s.ingestor.generation == sj.ingestor.generation
        assert s._sigma_sq == sj._sigma_sq and s.warm_level == sj.warm_level
        np.testing.assert_array_equal(s.prev_primal[0], sj.prev_primal[0])
        np.testing.assert_array_equal(s.prev_primal[1], sj.prev_primal[1])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scheduler_checkpoint_restores_across_packages(tmp_path, writer):
    """Two cadences in the writing package, a checkpoint, a restore in the
    other package, then one more cadence in both: warm in both, the same
    report keys and modes, and the restored state equal to the saved one."""
    kw = dict(cold=dict(iters_per_stage=40), warm_gammas=(1.0, 0.1))
    rng = np.random.default_rng(13)
    deltas = [{f"t{t}": _perturb(BASE_J, rng) for t in range(2)} for _ in range(2)]
    if writer == "jax":
        src = jsvc.Scheduler(_jax_service(**kw))
        for t in range(2):
            src.add_tenant(f"t{t}", BASE_J)
        src.run_cadence()
        _cadence(src, deltas[0], JaxDelta)
        src.save_checkpoint(JaxManager(str(tmp_path), async_write=False), 1)
        cfg = convert.service_config_from_reference(src.config)
        assert cfg == _service(**kw)
        dst = Scheduler(cfg, device="cpu")
        dst.restore_checkpoint(CheckpointManager(str(tmp_path)), 1)
        _assert_same_sessions(dst, src)
        after, after_src = _cadence(dst, deltas[1], InstanceDelta), \
            _cadence(src, deltas[1], JaxDelta)
    else:
        src = Scheduler(_service(**kw), device="cpu")
        for t in range(2):
            src.add_tenant(f"t{t}", BASE)
        src.run_cadence()
        _cadence(src, deltas[0], InstanceDelta)
        src.save_checkpoint(CheckpointManager(str(tmp_path), async_write=False), 1)
        dst = jsvc.Scheduler(_jax_service(**kw))
        dst.restore_checkpoint(JaxManager(str(tmp_path)), 1)
        _assert_same_sessions(src, dst)
        after, after_src = _cadence(dst, deltas[1], JaxDelta), \
            _cadence(src, deltas[1], InstanceDelta)
    for name in ("t0", "t1"):
        r, rs = after.reports[name], after_src.reports[name]
        assert r["mode"] == rs["mode"] == "warm" and r["cold_reason"] is None
        assert set(r) == set(rs)
        assert r["cadence"] == rs["cadence"] == 2
        assert r["upload_mode"] == "full"  # a restored session re-uploads once
        np.testing.assert_allclose(r["g"], rs["g"], rtol=1e-4)
    # the telemetry counters travelled with the checkpoint
    reg = (telemetry if writer == "jax" else jtel).get_registry()
    assert reg.counter_total("scheduler_cadences_total") >= 3
