"""Train step: loss -> grad -> clip -> AdamW, with microbatching (port of the
single-device half of `repro.training.train_step`).

`make_train_step` builds the step over `Model.loss` and autograd.  Gradient
accumulation loops over microbatches in the reference's order (loss and
grads each divided by the count and added to a running sum from zero).
With `donate=True`, the reference's `donate_argnums=(0,)`, the step updates
the state's tensors in place (`adamw_update_`) and returns them; with
`donate=False` it returns new tensors and leaves the state as it was.  The
mesh half (`state_pspecs`, `activation_sharding`, `lower_train_step`, a step
over a mesh) is ROADMAP Queue 1 item 3.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    adamw_update_,
    tree_map,
)

__all__ = ["TrainState", "init_train_state", "make_train_step", "value_and_grad"]


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    step: torch.Tensor  # int32, 0-dim


def init_train_state(model: Model, gen: Optional[torch.Generator] = None, *,
                     device="cuda") -> TrainState:
    """Fresh fp32 params drawn from `gen` (a generator seeded 0 on `device`
    when None), zero moments, step 0."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, state requested on {dev}")
    params = model.init(gen)
    return TrainState(
        params=params, opt=adamw_init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def value_and_grad(model: Model, params, batch) -> tuple[torch.Tensor, dict]:
    """(loss, grads of every param leaf): `jax.value_and_grad(model.loss)`.
    The params are not modified; the loss comes back detached."""
    leaves = []

    def track(p):
        p = p.detach().requires_grad_()
        leaves.append(p)
        return p

    loss = model.loss(tree_map(track, params), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    filled = iter(torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves))
    return loss.detach(), tree_map(lambda _: next(filled), params)


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    mesh=None,
    profile=None,
    *,
    microbatches: int = 1,
    donate: bool = True,
):
    """Returns (step fn, state_shardings, batch_sharding_fn), the shardings
    None on a single device.  step(state, batch) -> (state, metrics), the
    batch a dict of tensors on the state's device; metrics hold 0-dim
    tensors `loss`, `grad_norm` and `lr`."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step over a mesh (the sharded half of "
            "repro.training.train_step) is ROADMAP Queue 1 item 3"
        )

    def step_fn(state: TrainState, batch) -> tuple[TrainState, dict]:
        if microbatches > 1:
            def split(x):
                return x.reshape((microbatches, x.shape[0] // microbatches) + x.shape[1:])

            micro = {k: split(v) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
            grads = tree_map(torch.zeros_like, state.params)
            for i in range(microbatches):
                mb_loss, mb_grads = value_and_grad(model, state.params,
                                                   {k: v[i] for k, v in micro.items()})
                loss = loss + mb_loss / microbatches
                grads = tree_map(lambda a, g: a + g / microbatches, grads, mb_grads)
        else:
            loss, grads = value_and_grad(model, state.params, batch)
        if donate:
            params, opt, metrics = adamw_update_(opt_cfg, grads, state.opt, state.params)
            step = state.step.add_(1)
        else:
            params, opt, metrics = adamw_update(opt_cfg, grads, state.opt, state.params)
            step = state.step + 1
        return TrainState(params=params, opt=opt, step=step), dict(metrics, loss=loss)

    return step_fn, None, None
