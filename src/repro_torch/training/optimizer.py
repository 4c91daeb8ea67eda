"""AdamW with global-norm clipping and warmup+cosine schedule (port of
`repro.training.optimizer`).

The arithmetic is the reference's, op for op in fp32: the same element-wise
expression, the clip scale, the schedule and the bias corrections
(`b1 ** count` in fp32) as 0-dim tensors on the params' device, so a step
never waits on the host.  Two forms compute it:

  * `adamw_update` is the reference's functional form: it returns new
    params and moments and leaves its arguments alone;
  * `adamw_update_` updates the params and moments in place, leaf by leaf,
    overwriting the grads as scratch.  It is what the donating train step
    runs: XLA reuses the reference's donated buffers, and a whole new tree
    in eager PyTorch would hold two copies of params, m and v at once.

Both round every operation the same way, so they agree bit for bit.  Trees
are nested dicts and lists of tensors; leaves are visited in the
reference's order (`jax.tree.leaves`: dict keys sorted), which fixes the
order of the global norm's sum.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "adamw_update",
    "adamw_update_",
    "global_norm",
    "lr_schedule",
    "tree_leaves",
    "tree_map",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor  # int32, 0-dim


def tree_map(fn, *trees):
    """fn over the leaves of trees of one structure (dicts and lists)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in `jax.tree.leaves` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def adamw_init(params) -> OptState:
    leaf = tree_leaves(params)[0]
    return OptState(
        m=tree_map(torch.zeros_like, params),
        v=tree_map(torch.zeros_like, params),
        count=torch.zeros((), dtype=torch.int32, device=leaf.device),
    )


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    # NB: a sum over each leaf's own dims, NOT a flattened dot product, as in
    # the reference (which keeps a multi-axis sharding of every leaf intact)
    return torch.sqrt(
        sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree))
    )


def _scalars(cfg: AdamWConfig, grads, count: torch.Tensor):
    """(grad norm, clip scale, new count, lr, 1 - b1^count, 1 - b2^count)."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(
        torch.full_like(gnorm, cfg.clip_norm) / torch.clamp_min(gnorm, 1e-12), 1.0
    )
    count = count + 1
    lr = lr_schedule(cfg, count)
    c = count.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, c)
    b2c = 1.0 - torch.pow(cfg.b2, c)
    return gnorm, scale, count, lr, b1c, b2c


def adamw_update(cfg: AdamWConfig, grads, state: OptState, params):
    """Returns (new_params, new_state, metrics); the arguments are left as
    they are."""
    gnorm, scale, count, lr, b1c, b2c = _scalars(cfg, grads, state.count)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        step_ = lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p)
        return p - step_, m, v

    # trees hold only dict and list containers, so a tuple is one leaf's
    # (p, m, v) result
    out = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return (
        pick(0),
        OptState(m=pick(1), v=pick(2), count=count),
        {"grad_norm": gnorm, "lr": lr},
    )


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, grads, state: OptState, params):
    """`adamw_update` in place: params, m, v and the count are updated and
    returned (the same tensors); fp32 grads are overwritten as scratch.
    Rounds every operation as `adamw_update` does."""
    gnorm, scale, count, lr, b1c, b2c = _scalars(cfg, grads, state.count)

    def upd(p, g, m, v):
        g = g.to(torch.float32).mul_(scale)
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        den = torch.sqrt_(v / b2c).add_(cfg.eps)
        decay = g.copy_(p).mul_(cfg.weight_decay)  # g is spent: scratch
        p.sub_((m / b1c).div_(den).add_(decay).mul_(lr))

    tree_map(upd, params, grads, state.m, state.v)
    state.count.copy_(count)
    return params, state, {"grad_norm": gnorm, "lr": lr}
