"""Sharded serve steps: prefill and single-token decode (port of
`repro.serving.lm_demo.steps`).

decode_* / long_* shapes run `decode_step` - one new token against a
seq_len-deep cache - NOT the train step.  The cache is sequence-sharded over
the tp axis (GQA kv-head counts generally don't divide a 16-way axis), so
decode attention is a distributed softmax combine, which DTensor carries;
the new entry is written by the rank whose shard holds its position
(`models.layers._write_sharded`).

Params are DTensors on the rules' placements (`param_pspecs`), the batch and
the tokens are sharded over the dp axes (`batch_pspecs`), the cache is placed
by `cache_pspecs`; plain tensors given for any of them are sharded here (the
same full tensor on every rank, each keeping its shard).  The logits come
back as DTensors (`.full_tensor()` gathers them).  `lower_prefill` and
`lower_decode_step` run one call on meta-device shards under the running
group (the dry run's fake one) and return its account, as
`training.train_step.lower_train_step` does.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig, ShardingProfile
from repro_torch.models.model import Model
from repro_torch.training.optimizer import tree_map
from repro_torch.training.sharding_rules import (
    batch_pspecs,
    cache_pspecs,
    distribute,
    named,
    param_pspecs,
)

__all__ = ["make_serve_fns", "lower_decode_step", "lower_prefill", "shard_tree"]


def _param_placements(model: Model, mesh, profile: ShardingProfile):
    return named(mesh, param_pspecs(model.init(None, device="meta"), mesh, profile))


def shard_tree(tree, mesh, pl_tree):
    """Every tensor of `tree` on the placements of `pl_tree`: DTensors
    redistributed where they differ, plain (full) tensors sharded."""
    def one(x, pl):
        if hasattr(x, "placements"):
            return x if tuple(x.placements) == tuple(pl) else x.redistribute(mesh, pl)
        return distribute(x, mesh, pl)

    return tree_map(one, tree, pl_tree)


def make_serve_fns(model: Model, mesh, profile: ShardingProfile):
    """(prefill_fn, decode_fn) over `mesh`:

        prefill(params, batch, max_seq=None) -> (logits_last, cache)
        decode(params, tokens, pos, cache)   -> (logits, cache)

    the params placed by the rules, the cache by `cache_pspecs`; decode
    updates the cache's shards in place, as the single-device step does."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = model.cfg
    ppl = _param_placements(model, mesh, profile)

    def place_cache(cache):
        return shard_tree(cache, mesh, named(mesh, cache_pspecs(cache, cfg, profile, mesh)))

    def prefill(params, batch, max_seq=None):
        params = shard_tree(params, mesh, ppl)
        batch = shard_tree(batch, mesh, named(mesh, batch_pspecs(batch, profile, mesh)))
        with implicit_replication():
            logits, cache = model.prefill(params, batch, max_seq)
        return logits, place_cache(cache)

    def decode(params, tokens, pos, cache):
        params = shard_tree(params, mesh, ppl)
        tokens = shard_tree(tokens, mesh, named(mesh, batch_pspecs(tokens, profile, mesh)))
        with implicit_replication():
            return model.decode_step(params, tokens, pos, place_cache(cache))

    return prefill, decode


def _meta_params(model: Model, mesh, profile: ShardingProfile):
    return shard_tree(model.init(None, device="meta"), mesh,
                      _param_placements(model, mesh, profile))


def lower_decode_step(
    cfg: ModelConfig,
    specs: dict,  # {"tokens", "pos", "cache"} meta tensors (`configs.input_specs`)
    mesh,
    profile: ShardingProfile,
) -> dict:
    """Dry-run entry for decode_* / long_* cells: one decode step at the
    cache's last position (attention reads the whole cache at any
    position), on meta shards; returns its per-device account."""
    from repro_torch.analysis.comm_stats import TraceCounter, shard_bytes

    model = Model(cfg)
    _, decode = make_serve_fns(model, mesh, profile)
    params = _meta_params(model, mesh, profile)
    cache = shard_tree(specs["cache"], mesh,
                       named(mesh, cache_pspecs(specs["cache"], cfg, profile, mesh)))
    tokens = shard_tree(specs["tokens"], mesh,
                        named(mesh, batch_pspecs(specs["tokens"], profile, mesh)))
    seq = next((x.shape[2] for k, x in cache.items() if k not in ("h", "conv")), 1)
    with TraceCounter() as tc:
        decode(params, tokens, seq - 1, cache)
    return tc.account(params_bytes=shard_bytes(params), cache_bytes=shard_bytes(cache),
                      batch_bytes=shard_bytes(tokens))


def lower_prefill(
    cfg: ModelConfig,
    specs: dict,  # {"tokens"(, "embeds")} meta tensors
    mesh,
    profile: ShardingProfile,
) -> dict:
    """Dry-run entry for prefill_* cells: one prefill with the residual
    stream sequence-sharded (`activation_sharding`), on meta shards;
    returns its per-device account (the cache it builds included in the
    trace's live bytes)."""
    from repro_torch.analysis.comm_stats import TraceCounter, shard_bytes
    from repro_torch.training.train_step import activation_sharding

    model = Model(cfg)
    seq = (specs.get("embeds") if "embeds" in specs else specs["tokens"]).shape[1]
    model.act_sharding = activation_sharding(cfg, mesh, profile, seq)
    prefill, _ = make_serve_fns(model, mesh, profile)
    params = _meta_params(model, mesh, profile)
    batch = shard_tree(specs, mesh, named(mesh, batch_pspecs(specs, profile, mesh)))
    with TraceCounter() as tc:
        prefill(params, batch)
    return tc.account(params_bytes=shard_bytes(params), batch_bytes=shard_bytes(batch))
