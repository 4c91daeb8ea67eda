"""The port's training loss and gradients of the SSM (Mamba2 SSD), hybrid
(Mamba2 + shared attention) and encoder-decoder architectures against
`jax.value_and_grad(Model.loss)`.  Tolerances and helpers as
tests/test_torch_train_grads.py.
"""
import pytest

pytest.importorskip("jax")

from test_torch_train_grads import assert_match, check_remat, configs, reference_and_port  # noqa: E402

ARCHS = ("mamba2-1.3b", "zamba2-2.7b", "seamless-m4t-medium")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    assert_match(*reference_and_port(*configs(arch)))


def test_remat_grads_equal_no_remat():
    """The hybrid's shared block inside a checkpointed layer (the
    encoder-decoder's stacks: tests/test_torch_train_grads.py)."""
    check_remat("zamba2-2.7b")
