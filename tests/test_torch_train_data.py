"""The port's synthetic LM data pipeline against the JAX package's.

`repro_torch.data.SyntheticLMData` is numpy draw for draw the reference's,
so every batch is held bit-equal (`np.testing.assert_array_equal`, dtypes
included) for all ten reduced architectures, the `patch` (VLM) and
`frame`/encdec stubs among them, at several steps, seeds and a vocab cap.
Then the reference's own pipeline tests (tests/test_data.py) on the port.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro import configs as rconfigs  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RData  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402

ARCHS = rconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_bit_equal_to_reference(arch):
    rc, tc = rconfigs.get_reduced_config(arch), tconfigs.get_reduced_config(arch)
    for seed, cap in ((0, 0), (7, 0), (3, 100)):
        r = RData(rc, batch=4, seq=32, seed=seed, vocab_cap=cap)
        t = SyntheticLMData(tc, batch=4, seq=32, seed=seed, vocab_cap=cap)
        np.testing.assert_array_equal(t._shift, r._shift)
        for step in (0, 3, 100):
            a, b = t(step), r(step)
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (arch, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{arch} {k} step {step}")


def test_deterministic_per_step():
    cfg = tconfigs.get_reduced_config("qwen3-8b")
    d1 = SyntheticLMData(cfg, batch=4, seq=32, seed=7)
    d2 = SyntheticLMData(cfg, batch=4, seq=32, seed=7)
    for k in (0, 3, 100):
        a, b = d1(k), d2(k)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_steps_differ_and_seeds_differ():
    cfg = tconfigs.get_reduced_config("qwen3-8b")
    d = SyntheticLMData(cfg, batch=4, seq=32, seed=7)
    assert not np.array_equal(d(0)["tokens"], d(1)["tokens"])
    d2 = SyntheticLMData(cfg, batch=4, seq=32, seed=8)
    assert not np.array_equal(d(0)["tokens"], d2(0)["tokens"])


def test_labels_are_shifted_tokens():
    cfg = tconfigs.get_reduced_config("qwen3-8b")
    b = SyntheticLMData(cfg, batch=2, seq=16, seed=0)(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -100).all()


def test_learnable_signal():
    """The bigram structure makes next-token partially predictable."""
    cfg = tconfigs.get_reduced_config("qwen3-8b")
    d = SyntheticLMData(cfg, batch=8, seq=64, seed=1)
    b = d(0)
    hits = (d._shift[b["tokens"][:, :-1]] == b["tokens"][:, 1:]).mean()
    assert hits > 0.3  # ~50% by construction


def test_frontend_stubs():
    vlm = tconfigs.get_reduced_config("internvl2-76b")
    b = SyntheticLMData(vlm, batch=2, seq=32, seed=0)(0)
    P = vlm.frontend_len
    assert b["embeds"].shape == (2, P, vlm.d_model)
    assert b["tokens"].shape == (2, 32 - P)
    assert b["labels"].shape == (2, 32)
    assert (b["labels"][:, :P] == -100).all()

    enc = tconfigs.get_reduced_config("seamless-m4t-medium")
    b = SyntheticLMData(enc, batch=2, seq=32, seed=0)(0)
    assert b["embeds"].shape == (2, 32, enc.d_model)
    assert b["tokens"].shape == (2, 32)
