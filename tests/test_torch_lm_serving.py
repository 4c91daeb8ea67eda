"""The port's LM serving engine and CLI against the JAX package's.

`ServeEngine` on the same params (the reference's, carried by
`convert.lm_params_from_reference`) and the same requests gives the same
greedy tokens as the reference's engine in fp32 compute, slots admitted at
different positions included (the reference's shared-position decode); the
engine's one cast of the params at construction is bitwise the reference's
cast inside every step; two runs give the same tokens; and
`python -m repro_torch.launch.serve_lm --device cpu` serves every request.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_reduced_config as ref_config  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro.serving.lm_demo.engine import Request as RRequest  # noqa: E402
from repro.serving.lm_demo.engine import ServeEngine as RServeEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_reduced_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.lm_demo import Request, ServeEngine  # noqa: E402


def prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def run_engine(engine, request_cls, reqs, max_new):
    out = [request_cls(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(reqs)]
    for r in out:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in out)
    return [list(map(int, r.out_tokens)) for r in out]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_engine_tokens_match_reference(arch):
    """5 requests of unequal prompt lengths on 2 slots: a later admission
    decodes at the slots' shared position, in both packages."""
    rc = dataclasses.replace(ref_config(arch), dtype="float32")
    tc = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    rm, tm = RModel(rc), Model(tc)
    params = rm.init(jax.random.key(0))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, params), "cpu")
    reqs = prompts(rc.vocab_size, [8, 5, 8, 11, 3])
    want = run_engine(RServeEngine(rm, params, slots=2, max_seq=32), RRequest, reqs, 6)
    got = run_engine(ServeEngine(tm, tp, slots=2, max_seq=32), Request, reqs, 6)
    assert got == want


def test_engine_cast_once_is_bitwise_the_per_step_cast():
    """The engine casts the fp32 masters to bf16 once; `decode_step` casting
    inside every step (the reference's way) gives the same bits."""
    cfg = get_reduced_config("qwen3-8b")
    model = Model(cfg)
    master = model.init(torch.Generator().manual_seed(0))
    once = ServeEngine(model, master, slots=2, max_seq=24)
    assert all(v.dtype == torch.bfloat16 for v in once.params["blocks"]["attn"]["wq"].values())
    per_step = ServeEngine(model, master, slots=2, max_seq=24)
    per_step.params = master  # every decode_step casts the fp32 masters
    reqs = prompts(cfg.vocab_size, [6, 9, 4])
    assert run_engine(once, Request, reqs, 5) == run_engine(per_step, Request, reqs, 5)
    for name, leaf in once.cache.items():
        assert torch.equal(leaf, per_step.cache[name]), name
    tok = torch.tensor([[3], [7]])
    c1, c2 = model.init_cache(2, 8, device="cpu"), model.init_cache(2, 8, device="cpu")
    with torch.no_grad():
        for pos in range(3):
            a, c1 = model.decode_step(once.params, tok, pos, c1)
            b, c2 = model.decode_step(master, tok, pos, c2)
            assert torch.equal(a, b)
    # the cast copies nothing once the params are cast
    again = model._lowp(once.params)
    assert again["blocks"]["mlp"]["w_up"]["w"] is once.params["blocks"]["mlp"]["w_up"]["w"]


def test_engine_is_deterministic():
    cfg = get_reduced_config("deepseek-v2-236b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    reqs = prompts(cfg.vocab_size, [7, 7, 7])
    runs = [run_engine(ServeEngine(model, params, slots=2, max_seq=24), Request, reqs, 5)
            for _ in range(2)]
    assert runs[0] == runs[1]


def test_serve_lm_cli_on_cpu(capsys):
    assert serve_lm.main(["--device", "cpu", "--requests", "3", "--max-new", "5"]) == 0
    assert "3 requests, 15 tokens" in capsys.readouterr().out
    args = serve_lm.build_parser().parse_args(["--device", "cpu", "--arch", "zamba2-2.7b",
                                               "--requests", "5", "--slots", "2"])
    assert (args.prompt_len, args.max_new) == (16, 24)  # the reference's defaults
    run = serve_lm.run(args)
    assert [len(r.out_tokens) for r in run.requests] == [24] * 5
    assert all(r.done and all(0 <= t < run.cfg.vocab_size for t in r.out_tokens)
               for r in run.requests)
    assert run.tokens == 5 * 24 and run.seconds > 0


def test_serve_lm_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve_lm.main([])
