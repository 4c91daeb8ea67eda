"""The port's training loss and gradients of the two MoE architectures
against `jax.value_and_grad(Model.loss)`, with either router: `router="lp"`
(the paper's solver in the router: `project_simplex`'s analytic
derivative, `jnp.maximum`'s tie subgradient) and `router="topk"` (the
configs' own).  Batch 4 x 16: 64 tokens over the reduced 8 experts, so
capacity binds and the lp router's dual ascent moves.  Tolerances and
helpers as tests/test_torch_train_grads.py.
"""
import pytest

pytest.importorskip("jax")

from test_torch_train_grads import assert_match, check_remat, configs, reference_and_port  # noqa: E402

MOE = ("deepseek-v2-236b", "kimi-k2-1t-a32b")


@pytest.mark.parametrize("router", ["lp", "topk"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_grads_match_reference(arch, router):
    assert_match(*reference_and_port(*configs(arch, router=router), seed=1, batch=4))


def test_remat_grads_equal_no_remat():
    """The MLA prefix block and the MoE stack under checkpointing."""
    check_remat("deepseek-v2-236b")
