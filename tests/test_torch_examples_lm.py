"""The port's LM examples (`examples/lp_moe_routing_torch.py`,
`examples/serve_lm_torch.py`, `examples/train_lm_torch.py`) against the JAX
package's (`examples/lp_moe_routing.py`, `serve_lm.py`, `train_lm.py`).

The reference example runs in a child interpreter (`JAX_PLATFORMS=cpu`) and
its output is parsed; the port's runs in this process with `--device cpu`,
from the reference's params (`convert.lm_params_from_reference` of
`jax.random.key(0)`) or initial training state.  A printed figure is held
with its print resolution (`torch_examples.close_to_printed`).

* lp_moe_routing: the printed routing lines equal, the per-expert loads of
  both routers equal to the reference's on the same logits (computed here
  with `jax.lax.top_k`), the reduced kimi model's loss at rtol 1e-5.  The
  LP router's x ties exactly at the k-th place in many rows: the port's
  `top_k` puts the lower index first there, as `jax.lax.top_k` does, where
  `torch.topk` picks other experts.
* serve_lm: the engine-step count and the printed requests equal.  Every
  request's tokens equal in fp32 compute (the reduced config's dtype
  replaced in both packages); in the shipped bf16 a request can part ways
  at an exact tie of two bf16 logits, which XLA:CPU breaks in fp32 (it keeps
  bf16 intermediates in fp32 inside fusions; ROADMAP Queue 3).
* train_lm: the presets field for field, the printed lines, the logged
  losses at steps 10 and 20 at rtol 1e-4, and a short run that resumes.
"""
import ast
import dataclasses
import json
import logging
import os
import re
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_examples import one_torch_thread  # noqa: E402, F401 (an autouse fixture)
from torch_examples import (  # noqa: E402
    REPO, close_to_printed, example_args, field, load_example, reference_run,
)

from repro.configs import get_reduced_config as ref_config  # noqa: E402
from repro.models.config import ModelConfig as RModelConfig  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro.models.moe import lp_route as ref_lp_route  # noqa: E402
from repro.training.train_step import init_train_state as ref_init  # noqa: E402
from repro_torch.checkpoint.manager import _flatten  # noqa: E402
from repro_torch.convert import lm_params_from_reference, train_state_from_reference  # noqa: E402

SERVE_RUNNER = """
import dataclasses, json, runpy, sys
import repro.configs
from repro.serving.lm_demo import engine
get, dtype = repro.configs.get_reduced_config, sys.argv[1]
repro.configs.get_reduced_config = lambda arch: dataclasses.replace(get(arch), dtype=dtype)
submitted = []
submit = engine.ServeEngine.submit
def record(self, req):
    submitted.append(req)
    submit(self, req)
engine.ServeEngine.submit = record
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
print("TOKENS", json.dumps([[int(t) for t in r.out_tokens] for r in submitted]))
"""


@pytest.fixture(autouse=True)
def keep_sigterm_handler():
    """The checkpoint manager installs a SIGTERM save hook."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


# ------------------------------------------------------------ lp_moe_routing


def reference_loads(ids, E: int) -> np.ndarray:
    return np.bincount(np.asarray(ids).reshape(-1), minlength=E).astype(np.float64)


def test_lp_moe_routing_matches_reference(capsys):
    want = reference_run("lp_moe_routing").stdout
    cfg = ref_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router="lp", lp_iters=16))
    rmodel = RModel(cfg)
    rparams = rmodel.init(jax.random.key(0))
    mod = load_example("lp_moe_routing_torch")
    got = mod.run(example_args(mod), params=lm_params_from_reference(
        jax.tree.map(np.asarray, rparams), "cpu"))
    printed = capsys.readouterr().out
    for pattern in (r"(tokens=.*)", r"(top-k router : .*)", r"(LP router    : .*)"):
        assert field(printed, pattern) == field(want, pattern)

    # the loads whole, against the reference's routers on the example's logits
    rng = np.random.default_rng(0)
    T, E, k = 4096, 16, 2
    hot = rng.normal(size=E) * 2.0
    logits = rng.normal(size=(T, E)).astype(np.float32) + hot[None, :]
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    x = ref_lp_route(probs, k, capacity=float(got.capacity), iters=64, gamma=0.05)
    for (load, drop), routed in (((got.load_top, got.drop_top), probs),
                                 ((got.load_lp, got.drop_lp), x)):
        want_load = reference_loads(jax.lax.top_k(routed, k)[1], E)
        np.testing.assert_array_equal(load, want_load)
        assert drop == np.maximum(want_load - got.capacity, 0).sum() / want_load.sum()
    # x ties exactly at the k-th place in many rows, where torch.topk would
    # pick other experts than jax.lax.top_k
    x = torch.from_numpy(np.array(x))
    ranked = torch.sort(x, dim=-1, descending=True).values
    assert int((ranked[:, k - 1] == ranked[:, k]).sum()) > 0
    assert not np.array_equal(reference_loads(torch.topk(x, k).indices.numpy(), E), got.load_lp)

    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 32)), jnp.int32)
    ref_loss = float(jax.jit(rmodel.loss)(rparams, {"tokens": toks, "labels": toks}))
    np.testing.assert_allclose(got.loss, ref_loss, rtol=1e-5)
    assert close_to_printed(got.loss, field(want, r"loss=(\S+) "), 1e-5)


# ------------------------------------------------------------------ serve_lm


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serve_lm_matches_reference(monkeypatch, capsys, dtype):
    proc = reference_run("serve_lm", runner=SERVE_RUNNER, runner_args=[dtype])
    want = proc.stdout
    want_tokens = json.loads(field(want, r"TOKENS (.*)"))
    params = RModel(ref_config("qwen3-8b")).init(jax.random.key(0))
    mod = load_example("serve_lm_torch")
    get = mod.get_reduced_config
    monkeypatch.setattr(mod, "get_reduced_config",
                        lambda arch: dataclasses.replace(get(arch), dtype=dtype))
    got = mod.run(example_args(mod), params=lm_params_from_reference(
        jax.tree.map(np.asarray, params), "cpu"))
    printed = capsys.readouterr().out
    assert got.steps == int(field(want, r"in (\d+) engine steps"))
    assert re.findall(r"  req .*", printed) == re.findall(r"  req .*", want)
    tokens = sorted((r.rid, [int(t) for t in r.out_tokens]) for r in got.done)
    assert [rid for rid, _ in tokens] == list(range(8))
    assert all(len(t) == 24 for _, t in tokens)
    if dtype == "float32":
        assert [t for _, t in tokens] == want_tokens


# ------------------------------------------------------------------ train_lm


def reference_presets() -> dict:
    """examples/train_lm.py's PRESETS, read from its source (the reference's
    examples are not imported here: train_lm.py configures logging on
    import)."""
    tree = ast.parse(open(os.path.join(REPO, "examples", "train_lm.py")).read())
    node = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "PRESETS")
    return {ast.literal_eval(key): {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}
            for key, call in zip(node.keys, node.values)}


def test_train_lm_presets_are_the_reference_presets():
    mod = load_example("train_lm_torch")
    want = reference_presets()
    assert sorted(mod.PRESETS) == sorted(want)
    for name, fields in want.items():
        assert mod.PRESETS[name] == dataclasses.replace(mod.PRESETS[name], **fields)
        assert dataclasses.asdict(mod.PRESETS[name]) == dataclasses.asdict(RModelConfig(**fields))


def test_train_lm_matches_reference(tmp_path, capsys, caplog):
    args = ["--steps", "20", "--batch", "2", "--seq", "32"]
    proc = reference_run("train_lm", args + ["--ckpt-dir", str(tmp_path / "reference")])
    mod = load_example("train_lm_torch")
    rc = RModelConfig(**reference_presets()["10m"])
    state = train_state_from_reference(
        jax.tree.map(np.asarray, ref_init(RModel(rc), jax.random.key(0))), "cpu")
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        got = mod.run(example_args(mod, *args, "--ckpt-dir", str(tmp_path / "port")), state=state)
    printed = capsys.readouterr().out
    assert field(printed, r"(model: .*)") == field(proc.stdout, r"(model: .*)")
    assert "finished at step 20;" in printed and "finished at step 20;" in proc.stdout
    assert sorted(got.losses) == [10, 20]
    for step, loss in got.losses.items():
        assert close_to_printed(loss, field(proc.stderr, rf"step {step} loss (\S+) "), 1e-4)
        assert f"step {step} loss {loss:.4f}" in caplog.text


def test_train_lm_resumes(tmp_path, caplog):
    mod = load_example("train_lm_torch")
    args = example_args(mod, "--steps", "4", "--batch", "2", "--seq", "32",
                   "--ckpt-dir", str(tmp_path))
    first = mod.run(args)
    assert (tmp_path / "step_00000004").is_dir()
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        again = mod.run(args)
    assert "resumed from step 4" in caplog.text
    assert int(again.state.step) == 4 and again.losses == {}
    want, got = _flatten(first.state), _flatten(again.state)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
