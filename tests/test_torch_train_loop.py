"""The port's training loop (`repro_torch.training.train_loop`), its
checkpoints and its CLI, against the JAX package's.

* The checkpoint path format renders a NamedTuple field as `.name`, as
  `jax.tree_util.keystr` does: a `TrainState` is saved under the reference's
  keys (`.params['embed']`, `.opt.m[...]`, `.opt.count`, `.step`).
* A reference `train_loop` checkpoint resumes in the port's `train_loop`,
  and a port checkpoint in the reference's; reduced qwen3-8b in fp32, each
  resumed run's losses against the uninterrupted run of the other package
  at rtol 1e-4 (the trajectory tolerance of tests/test_torch_train_step.py).
* A SIGTERM during a step saves the state as the step left it, whole.
* The bounded retry; the CLI on the CPU, and its resume bit for bit.
"""
import dataclasses
import logging
import shutil
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.checkpoint.manager import _flatten as r_flatten  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RData  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro.training.loop import TrainLoopConfig as RLoopConfig, train_loop as r_train_loop  # noqa: E402
from repro.training.optimizer import AdamWConfig as RAdamW  # noqa: E402
from repro.training.train_step import init_train_state as r_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, latest_step  # noqa: E402
from repro_torch.checkpoint.manager import _flatten  # noqa: E402
from repro_torch.convert import train_state_from_reference  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig, TrainLoopConfig, init_train_state, make_train_step, train_loop,
)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def keep_sigterm_handler():
    """Both packages' checkpoint managers install a SIGTERM save hook."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def fp32():
    return (dataclasses.replace(rconfigs.get_reduced_config("qwen3-8b"), dtype="float32"),
            dataclasses.replace(tconfigs.get_reduced_config("qwen3-8b"), dtype="float32"))


def reference_init(rc):
    """The reference loop's initial state, as the port's tensors."""
    return train_state_from_reference(
        jax.tree.map(np.asarray, r_init(RModel(rc), jax.random.key(0))), "cpu")


def test_train_state_checkpoint_keys_are_the_reference_keys():
    rc, _ = fp32()
    rstate = r_init(RModel(rc), jax.random.key(0))
    want = r_flatten(rstate)
    got = _flatten(train_state_from_reference(jax.tree.map(np.asarray, rstate), "cpu"))
    assert list(got) == list(want)
    assert {".step", ".opt.count", ".params['embed']", ".opt.m['blocks']['attn']['wq']['w']"} <= set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


def losses_into(out):
    return lambda k, m: out.__setitem__(k, float(m["loss"]))


def test_reference_checkpoint_resumes_in_port(tmp_path):
    rc, tc = fp32()
    r_full = {}
    r_train_loop(RModel(rc), RData(rc, 8, 32), RAdamW(**OPT), RLoopConfig(total_steps=10),
                 on_step=losses_into(r_full))
    r_train_loop(RModel(rc), RData(rc, 8, 32), RAdamW(**OPT),
                 RLoopConfig(total_steps=5, save_every=5), ckpt_dir=str(tmp_path))
    assert latest_step(str(tmp_path)) == 5
    t_resumed = {}
    state = train_loop(Model(tc), SyntheticLMData(tc, 8, 32), AdamWConfig(**OPT),
                       TrainLoopConfig(total_steps=10, save_every=5), str(tmp_path),
                       on_step=losses_into(t_resumed), device="cpu")
    assert sorted(t_resumed) == list(range(5, 10)) and int(state.step) == 10
    assert int(state.opt.count) == 10
    np.testing.assert_allclose([t_resumed[k] for k in range(5, 10)],
                               [r_full[k] for k in range(5, 10)], rtol=1e-4)


def test_port_checkpoint_resumes_in_reference(tmp_path):
    rc, tc = fp32()
    t_full = {}
    train_loop(Model(tc), SyntheticLMData(tc, 8, 32), AdamWConfig(**OPT),
               TrainLoopConfig(total_steps=10), state=reference_init(rc),
               on_step=losses_into(t_full), device="cpu")
    train_loop(Model(tc), SyntheticLMData(tc, 8, 32), AdamWConfig(**OPT),
               TrainLoopConfig(total_steps=5, save_every=5), str(tmp_path),
               state=reference_init(rc), device="cpu")
    assert latest_step(str(tmp_path)) == 5
    r_resumed = {}
    state = r_train_loop(RModel(rc), RData(rc, 8, 32), RAdamW(**OPT),
                         RLoopConfig(total_steps=10, save_every=5), ckpt_dir=str(tmp_path),
                         on_step=losses_into(r_resumed))
    assert sorted(r_resumed) == list(range(5, 10)) and int(state.step) == 10
    np.testing.assert_allclose([r_resumed[k] for k in range(5, 10)],
                               [t_full[k] for k in range(5, 10)], rtol=1e-4)


def test_sigterm_during_a_step_saves_the_whole_step(tmp_path):
    """A SIGTERM that arrives halfway through a step's in-place update is
    held until the step is whole: the save hook writes params and step
    counter of the same step, then the loop exits with 143."""
    _, tc = fp32()
    model = Model(tc)
    start = init_train_state(model, device="cpu")
    first = [x.clone() for x in tree_leaves(start.params)]

    def two_halves(state, batch):
        for p in tree_leaves(state.params):
            p.add_(1.0)
        if int(state.step) == 2:
            signal.raise_signal(signal.SIGTERM)
        state.step.add_(1)
        return state, {"loss": torch.zeros(())}

    with pytest.raises(SystemExit) as exc:
        train_loop(model, SyntheticLMData(tc, 2, 8), AdamWConfig(),
                   TrainLoopConfig(total_steps=10, save_every=100), str(tmp_path),
                   state=start, step_fn=two_halves, device="cpu")
    assert exc.value.code == 143
    assert latest_step(str(tmp_path)) == 3
    saved = CheckpointManager(str(tmp_path)).restore(3, init_train_state(model, device="cpu"))
    assert int(saved.step) == 3
    for a, b in zip(tree_leaves(saved.params), first):
        assert torch.equal(a, b.add(1.0).add(1.0).add(1.0))


def test_bounded_retry(tmp_path, caplog):
    _, tc = fp32()
    model = Model(tc)
    step, _, _ = make_train_step(model, AdamWConfig())
    calls = []

    def flaky(state, batch):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("transient")
        return step(state, batch)

    data = SyntheticLMData(tc, 2, 8)
    with caplog.at_level(logging.ERROR, logger="repro_torch.train"):
        state = train_loop(model, data, AdamWConfig(), TrainLoopConfig(total_steps=3),
                           step_fn=flaky, device="cpu")
    assert int(state.step) == 3 and len(calls) == 4
    assert "step 1 failed (attempt 0); retrying" in caplog.text

    def broken(state, batch):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        train_loop(model, data, AdamWConfig(), TrainLoopConfig(total_steps=3, max_retries=1),
                   str(tmp_path), step_fn=broken, device="cpu")
    assert latest_step(str(tmp_path)) == 0


def test_cli_runs_and_resumes_bit_for_bit(tmp_path, capsys, caplog):
    """`--steps 6 --save-every 3` uninterrupted, and again from its step-3
    checkpoint alone (a run stopped after that save): the two final
    checkpoints are bit-equal.  Without a card the default device refuses."""
    args = ["--arch", "qwen3-8b", "--reduced", "--steps", "6", "--batch", "2", "--seq", "16",
            "--save-every", "3", "--device", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    assert train_cli.main(args + ["--ckpt-dir", str(a)]) == 0
    assert latest_step(str(a)) == 6
    shutil.copytree(a / "step_00000003", b / "step_00000003")
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        assert train_cli.main(args + ["--ckpt-dir", str(b)]) == 0
    assert "resumed from step 3" in caplog.text
    assert capsys.readouterr().out.count("done at step 6") == 2
    full, _ = CheckpointManager(str(a)).restore_flat(6)
    resumed, _ = CheckpointManager(str(b)).restore_flat(6)
    assert sorted(full) == sorted(resumed)
    for k in full:
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(args[:-2])
