"""The port's training loss and its gradients against
`jax.value_and_grad(Model.loss)` of the JAX package: the dense, GQA and VLM
architectures here, the MoE ones in test_torch_train_grads_moe.py, the SSM,
hybrid and encoder-decoder ones in test_torch_train_grads_ssm.py (split so
that the test workers share the reference's compiles); the three files
cover all ten.

Reduced configs in fp32 compute (`dataclasses.replace(cfg, dtype="float32")`:
XLA:CPU keeps bf16 intermediates in fp32, so bf16 is no common ground),
params built by the reference's `Model.init` and carried over by
`convert.lm_params_from_reference`, batches from the shared synthetic
pipeline (numpy, bit-equal in both packages).  The loss is held at rtol
1e-5 and every gradient leaf, path by path, at atol 1e-5.  The MoE
architectures run with `router="lp"` (the paper's solver in the router:
`project_simplex`'s analytic derivative, `jnp.maximum`'s tie subgradient)
and `router="topk"`; `remat=True` (activation checkpointing of every block)
gives the same gradients as `remat=False`, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data.pipeline import SyntheticLMData  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.manager import _items  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.training import value_and_grad  # noqa: E402

DENSE = ("qwen3-8b", "gemma-7b", "qwen2-72b", "starcoder2-7b", "internvl2-76b")


def configs(arch, **kw):
    kw.setdefault("dtype", "float32")
    rc, tc = rconfigs.get_reduced_config(arch), tconfigs.get_reduced_config(arch)
    if "router" in kw:
        router = kw.pop("router")
        kw_r = dict(kw, moe=dataclasses.replace(rc.moe, router=router))
        kw_t = dict(kw, moe=dataclasses.replace(tc.moe, router=router))
        return dataclasses.replace(rc, **kw_r), dataclasses.replace(tc, **kw_t)
    return dataclasses.replace(rc, **kw), dataclasses.replace(tc, **kw)


def reference_and_port(rc, tc, seed=0, batch=2, seq=16, *, reference=True):
    """(reference loss, reference grads by path, port loss, port grads by
    path) on one pipeline batch; the reference's None unless `reference`."""
    rm = RModel(rc)
    params = rm.init(jax.random.key(seed))
    data = SyntheticLMData(rc, batch=batch, seq=seq, seed=seed)(0)
    loss = rgrads = None
    if reference:
        loss, grads = jax.jit(jax.value_and_grad(rm.loss))(
            params, {k: jnp.asarray(v) for k, v in data.items()})
        flat = jax.tree_util.tree_flatten_with_path(grads)[0]
        rgrads = {jax.tree_util.keystr(p): np.asarray(g) for p, g in flat}
        loss = float(loss)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, params), "cpu")
    tloss, tgrads = value_and_grad(TModel(tc), tp, {k: torch.from_numpy(v) for k, v in data.items()})
    return loss, rgrads, float(tloss), dict(_items(tgrads))


def assert_match(rloss, rgrads, tloss, tgrads):
    np.testing.assert_allclose(tloss, rloss, rtol=1e-5)
    assert sorted(tgrads) == sorted(rgrads)
    for k, g in rgrads.items():
        assert tuple(tgrads[k].shape) == g.shape and tgrads[k].dtype == torch.float32, k
        np.testing.assert_allclose(tgrads[k].numpy(), g, atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    assert_match(*reference_and_port(*configs(arch)))


def check_remat(arch):
    """Checkpointed blocks recompute the same forward: loss and grads
    bit-equal to remat=False, and matching the reference's remat=True."""
    rc, tc = configs(arch, remat=True)
    rloss, rgrads, tloss, tgrads = reference_and_port(rc, tc)
    assert_match(rloss, rgrads, tloss, tgrads)
    _, _, loss0, grads0 = reference_and_port(*configs(arch, remat=False), reference=False)
    assert tloss == loss0
    for k, g in grads0.items():
        assert torch.equal(tgrads[k], g), k


@pytest.mark.parametrize("arch", ["qwen3-8b", "seamless-m4t-medium"])
def test_remat_grads_equal_no_remat(arch):
    """The main stack; the encoder-decoder's encoder and decoder stacks."""
    check_remat(arch)
