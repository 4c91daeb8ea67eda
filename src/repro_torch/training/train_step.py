"""Train step: loss -> grad -> clip -> AdamW, with microbatching (port of
`repro.training.train_step`).

`make_train_step` builds the step over `Model.loss` and autograd.  Gradient
accumulation loops over microbatches in the reference's order (loss and
grads each divided by the count and added to a running sum from zero).
With `donate=True`, the reference's `donate_argnums=(0,)`, the step updates
the state's tensors in place (`adamw_update_`) and returns them; with
`donate=False` it returns new tensors and leaves the state as it was.

Over a mesh (a `DeviceMesh`), the counterpart of the reference's GSPMD
step: params, moments, grads and the batch are DTensors with the rules'
placements (`sharding_rules`), the residual stream is redistributed between
blocks by `activation_sharding` (batch over dp, sequence over tp where it
divides), and DTensor carries every op of the model, its collectives
included.  Plain tensors inside the model (positions, masks, constants) act
as replicated (`implicit_replication`).  Each grad is redistributed to its
param's placements before AdamW, which then runs shard by shard with the
single-device rounding; the clip's global norm is a full reduction over the
shards.  `init_sharded_state` and `gather_state` move a state onto and off
the mesh.  `lower_train_step` runs one step on the meta device under the
running group (the dry run's fake one) and returns its account.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, ShardingProfile
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    adamw_update_,
    tree_map,
)
from repro_torch.training.sharding_rules import (
    batch_pspecs,
    distribute,
    maybe_shard,
    named,
    param_pspecs,
    placements,
)

__all__ = ["TrainState", "init_train_state", "make_train_step", "value_and_grad",
           "state_pspecs", "activation_sharding", "ActivationSharding",
           "init_sharded_state", "gather_state", "lower_train_step"]


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
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))

    def fill(i):  # each grad dropped once placed: no second copy of them all
        g, grads[i] = grads[i], None
        return _like(torch.zeros_like(leaves[i]) if g is None else g, leaves[i])

    filled = iter(fill(i) for i in range(len(leaves)))
    return loss.detach(), tree_map(lambda _: next(filled), params)


def _like(g, p):
    """A grad on its param's placements (a DTensor grad may come back
    partial or differently sharded); plain tensors as they are."""
    if hasattr(p, "placements") and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


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
    tensors `loss`, `grad_norm` and `lr`.

    Over a mesh the state is a DTensor state on the placements
    `state_shardings` (`init_sharded_state`), the batch a dict of full
    tensors (each rank passes the same batch and keeps its shard) or of
    DTensors, and `batch_sharding_fn(batch)` gives the batch's placements;
    the metrics come back as replicated plain tensors."""
    if mesh is not None:
        if not isinstance(profile, ShardingProfile):
            raise ValueError("make_train_step over a mesh needs its ShardingProfile "
                             "(launch.mesh.default_profile)")
        return _make_mesh_step(model, opt_cfg, mesh, profile, microbatches, donate)

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


# ---------------------------------------------------------------------- mesh


class ActivationSharding:
    """The placements of the [B, S, d] residual stream on a mesh: `Model._c`
    calls it between blocks (the reference's `with_sharding_constraint`)."""

    def __init__(self, mesh, spec: tuple):
        self.mesh = mesh
        self.spec = spec
        self.placements = placements(spec, mesh)

    def __call__(self, h):
        if tuple(h.placements) == self.placements:
            return h
        return h.redistribute(self.mesh, self.placements)


def activation_sharding(cfg: ModelConfig, mesh, profile: ShardingProfile, seq: int):
    """Sequence-parallel residual-stream sharding (batch over dp, seq over tp
    when divisible) - caps the per-layer saved activations."""
    dp = tuple(profile.dp_axes)
    return ActivationSharding(
        mesh, (dp[0] if len(dp) == 1 else dp, maybe_shard(seq, profile.tp_axis, mesh), None))


def state_pspecs(model: Model, mesh, profile: ShardingProfile) -> TrainState:
    pspec = param_pspecs(model.init(None, device="meta"), mesh, profile)
    return TrainState(params=pspec, opt=OptState(m=pspec, v=pspec, count=()), step=())


def init_sharded_state(model: Model, mesh, profile: ShardingProfile,
                       gen: Optional[torch.Generator] = None, *, state: Optional[TrainState] = None):
    """The train state on the mesh's placements: `state` (full tensors, the
    same on every rank: a fresh `init_train_state` from `gen`, or a restored
    checkpoint), each rank keeping its shards."""
    if state is None:
        state = init_train_state(model, gen, device=mesh.device_type)
    pl = named(mesh, state_pspecs(model, mesh, profile))
    return _map_state(lambda x, p: distribute(x, mesh, p), state, pl)


def _map_state(fn, state: TrainState, *others: TrainState) -> TrainState:
    """fn over the leaves of train states of one structure."""
    leaf = lambda get: fn(get(state), *(get(o) for o in others))
    tree = lambda get: tree_map(fn, get(state), *(get(o) for o in others))
    return TrainState(
        params=tree(lambda s: s.params),
        opt=OptState(m=tree(lambda s: s.opt.m), v=tree(lambda s: s.opt.v),
                     count=leaf(lambda s: s.opt.count)),
        step=leaf(lambda s: s.step))


def gather_state(state: TrainState) -> TrainState:
    """The full tensors of a sharded state (a collective: every rank calls
    it); plain tensors come back as they are."""
    return _map_state(lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x, state)


def _split_micro(x, mesh, pl, i: int, n: int):
    """Microbatch i of n of a sharded batch leaf: the reference's split of
    the global batch (rows i*B/n .. (i+1)*B/n), sharded again."""
    from torch.distributed.tensor import Replicate

    full = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    rows = x.shape[0] // n
    return full[i * rows:(i + 1) * rows].redistribute(mesh, pl)


def _local_metric(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _make_mesh_step(model: Model, opt_cfg: AdamWConfig, mesh, profile: ShardingProfile,
                    microbatches: int, donate: bool):
    from torch.distributed.tensor.experimental import implicit_replication

    state_shardings = named(mesh, state_pspecs(model, mesh, profile))

    def batch_shardings(batch_shape):
        return named(mesh, batch_pspecs(batch_shape, profile, mesh))

    def place_batch(batch):
        pl = batch_shardings(batch)
        return {k: v.redistribute(mesh, pl[k]) if hasattr(v, "placements")
                else distribute(v, mesh, pl[k]) for k, v in batch.items()}, pl

    def step_fn(state: TrainState, batch) -> tuple[TrainState, dict]:
        batch, bpl = place_batch(batch)
        key = ("embeds" if "embeds" in batch else "tokens") if model.cfg.encdec else "labels"
        seq = batch[key].shape[1]
        prev = model.act_sharding
        model.act_sharding = activation_sharding(model.cfg, mesh, profile, seq)
        try:
            with implicit_replication():
                if microbatches > 1:
                    loss = torch.zeros((), dtype=torch.float32, device=mesh.device_type)
                    grads = tree_map(torch.zeros_like, state.params)
                    for i in range(microbatches):
                        mb = {k: _split_micro(v, mesh, bpl[k], i, microbatches)
                              for k, v in batch.items()}
                        mb_loss, mb_grads = value_and_grad(model, state.params, mb)
                        loss = loss + mb_loss / microbatches
                        grads = tree_map(lambda a, g: a + g / microbatches, grads, mb_grads)
                else:
                    loss, grads = value_and_grad(model, state.params, batch)
                if donate:
                    params, opt, metrics = adamw_update_(opt_cfg, grads, state.opt, state.params)
                    step = state.step.add_(1)
                else:
                    params, opt, metrics = adamw_update(opt_cfg, grads, state.opt,
                                                        state.params)
                    step = state.step + 1
                metrics = {k: _local_metric(v) for k, v in dict(metrics, loss=loss).items()}
        finally:
            model.act_sharding = prev
        return TrainState(params=params, opt=opt, step=step), metrics

    return step_fn, state_shardings, batch_shardings


def lower_train_step(
    cfg: ModelConfig,
    batch_specs: dict,
    mesh,
    profile: ShardingProfile,
    opt_cfg: Optional[AdamWConfig] = None,
    *,
    microbatches: int = 1,
) -> dict:
    """Dry-run entry: one train step on meta-device shards (no storage) over
    `mesh` and the running group; returns its account
    (`analysis.comm_stats.TraceCounter.account`): per-shard bytes of params,
    moments and batch, the collectives, the FLOPs and the peak of the
    step's own live bytes, per device."""
    from repro_torch.analysis.comm_stats import TraceCounter, shard_bytes

    model = Model(cfg)
    opt_cfg = opt_cfg or AdamWConfig()
    step, state_pl, batch_pl = make_train_step(model, opt_cfg, mesh, profile,
                                               microbatches=microbatches)
    meta = _meta_state(model)
    state = _map_state(lambda x, p: distribute(x, mesh, p), meta, state_pl)
    bpl = batch_pl(batch_specs)
    batch = {k: distribute(v, mesh, bpl[k]) for k, v in batch_specs.items()}
    with TraceCounter() as tc:
        step(state, batch)
    return tc.account(
        params_bytes=shard_bytes(state.params),
        opt_bytes=shard_bytes([state.opt.m, state.opt.v]),
        batch_bytes=shard_bytes(batch))


def _meta_state(model: Model) -> TrainState:
    """A train state of meta tensors: shapes and dtypes only."""
    params = model.init(None, device="meta")
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device="meta"))
