"""Unified model builder: one functional Model for all assigned families
(port of the serving half of `repro.models.model`).

Families and their block stacks:
  dense / vlm : [embed (+patch stub)] -> attn+MLP blocks -> head
  moe         : prefix dense layer(s) -> attn+MoE blocks -> head
                (deepseek-v2 uses MLA attention; kimi-k2 uses GQA)
  ssm         : Mamba2 SSD blocks
  hybrid      : Mamba2 blocks with a *shared* attention block applied
                every `attn_period` layers
  encdec      : encoder blocks (bidirectional) + decoder blocks (causal + cross)

Params are a dict with the reference's tree paths: per-layer params stacked
along a leading layer dimension (`blocks`, `enc_blocks`, `dec_blocks`), the
MoE stacks' dense `prefix` a list, the hybrid's one `shared_attn`.  Each
`lax.scan` of the reference over layers is a Python loop over that leading
dimension.  Entry points:

  init(gen)                              -> params (fp32 masters)
  loss(params, batch)                    -> scalar LM loss (autograd-ready)
  prefill(params, batch, max_seq)        -> (logits_last, cache)
  decode_step(params, token, pos, cache) -> (logits, cache)
  init_cache(batch, seq)                 -> cache dict

`decode_step` updates the cache's tensors in place and returns the cache
(the reference's engine donates the cache to each step).  The training
forward unbinds each stacked leaf once (`_unstack`: its backward is one
stack, where a per-layer `x[i]` would write a zero tensor the size of the
whole stack per layer) and, under `cfg.remat`, checkpoints every block
(`torch.utils.checkpoint`, the reference's `jax.checkpoint`).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

__all__ = ["Model"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _unstack(tree, n: int) -> list:
    """The n layers of a stacked param tree (views, no copies), every leaf
    unbound once."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL in fp32 over the labels >= 0 (-100 = ignore).
    DTensor logits sharded over the vocabulary (a sequence the tp axis does
    not divide) are made whole on it first: the label gather has no
    vocab-parallel rule that holds here."""
    if hasattr(logits, "placements"):
        from torch.distributed.tensor import Replicate, Shard

        last = logits.ndim - 1
        pl = [Replicate() if p == Shard(last) else p for p in logits.placements]
        if pl != list(logits.placements):
            logits = logits.redistribute(logits.device_mesh, pl)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, torch.clamp_min(labels, 0).long()[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    nll = (lse - picked) * valid
    return torch.sum(nll) / torch.clamp_min(torch.sum(valid), 1.0)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _device(device) -> torch.device:
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def _set_layer(stack: torch.Tensor, i: int, value: torch.Tensor) -> None:
    """stack[i] = value, in place; a DTensor stack is written shard by
    shard (value placed as the layer is) rather than through DTensor's
    setitem."""
    if hasattr(stack, "placements"):
        dst = stack[i]
        dst.to_local().copy_(value.redistribute(dst.device_mesh, dst.placements).to_local())
    else:
        stack[i] = value


def _pad_seq(x: torch.Tensor, max_seq: Optional[int]) -> torch.Tensor:
    """Zero-pad dim 2 (the cache's sequence dim) up to max_seq."""
    if max_seq is None or max_seq - x.shape[2] <= 0:
        return x
    pad = [0, 0] * (x.ndim - 3) + [0, max_seq - x.shape[2]]
    if hasattr(x, "placements"):  # on the local shards, the sequence whole
        from torch.distributed.tensor import DTensor, Replicate, Shard

        pl = [Replicate() if p == Shard(2) else p for p in x.placements]
        local = torch.nn.functional.pad(x.redistribute(x.device_mesh, pl).to_local(), pad)
        return DTensor.from_local(local, x.device_mesh, pl, run_check=False)
    return torch.nn.functional.pad(x, pad)


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        # Megatron-style sequence-parallel activation placement: a
        # `training.train_step.ActivationSharding` (DTensor placements of
        # the [B, S, d] hiddens on a mesh), set by the mesh train step and
        # `lower_prefill`; None on single-device paths, where `_c` is the
        # identity.  Applied to the residual stream between blocks, so each
        # layer's saved carry is sharded over the tp axis as well as the
        # batch.
        self.act_sharding = None

    def _c(self, h):
        if self.act_sharding is not None and h.ndim == 3 and h.shape[1] > 1:
            return self.act_sharding(h)
        return h

    def _lowp(self, params):
        """Cast >=2D fp32 weights to the compute dtype.  Stacked 1D params
        (norm scales of `blocks`) are 2D and cast too, as in the reference;
        the prefix's and the shared block's 1D params stay fp32.  Idempotent:
        params already cast come back as they are (no copy)."""
        dt = _dtype(self.cfg)
        cast = lambda x: x.to(dt) if (x.dtype == torch.float32 and x.ndim >= 2) else x
        return _tree_map(cast, params)

    # ------------------------------------------------------------------ init
    def _init_block(self, init: L.ParamInit) -> dict:
        cfg = self.cfg
        if cfg.family == "ssm" or (cfg.family == "hybrid"):
            return {
                "ln": init.ones((cfg.d_model,)),
                "mamba": S.init_mamba(init, cfg),
            }
        p: dict[str, Any] = {
            "ln1": init.ones((cfg.d_model,)),
            "ln2": init.ones((cfg.d_model,)),
        }
        if cfg.mla is not None:
            p["attn"] = L.init_mla(init, cfg)
        else:
            p["attn"] = L.init_attention(init, cfg)
        if cfg.family == "moe":
            p["moe"] = M.init_moe(init, cfg)
        else:
            p["mlp"] = L.init_mlp(init, cfg.d_model, cfg.d_ff)
        return p

    def _init_dense_block(self, init: L.ParamInit, ff: int) -> dict:
        cfg = self.cfg
        p = {
            "ln1": init.ones((cfg.d_model,)),
            "ln2": init.ones((cfg.d_model,)),
            "mlp": L.init_mlp(init, cfg.d_model, ff),
        }
        if cfg.mla is not None:
            p["attn"] = L.init_mla(init, cfg)
        else:
            p["attn"] = L.init_attention(init, cfg)
        return p

    def _init_shared_attn(self, init: L.ParamInit) -> dict:
        cfg = self.cfg
        return {
            "ln1": init.ones((cfg.d_model,)),
            "ln2": init.ones((cfg.d_model,)),
            "attn": L.init_attention(init, cfg),
            "mlp": L.init_mlp(init, cfg.d_model, cfg.d_ff),
        }

    def _init_xblock(self, init: L.ParamInit) -> dict:
        """Encoder-decoder decoder block: self-attn + cross-attn + MLP."""
        cfg = self.cfg
        return {
            "ln1": init.ones((cfg.d_model,)),
            "ln_x": init.ones((cfg.d_model,)),
            "ln2": init.ones((cfg.d_model,)),
            "attn": L.init_attention(init, cfg),
            "xattn": L.init_attention(init, cfg),
            "mlp": L.init_mlp(init, cfg.d_model, cfg.d_ff),
        }

    def init(self, gen: Optional[torch.Generator], *, device=None) -> dict:
        """fp32 master params drawn from `gen` on its device (on
        `device="meta"`: shapes only, `gen` may be None)."""
        cfg = self.cfg
        init = L.ParamInit(gen, device)
        params: dict[str, Any] = {
            "embed": init.normal((cfg.vocab_size, cfg.d_model), 0.01),
            "final_norm": init.ones((cfg.d_model,)),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init.normal((cfg.d_model, cfg.vocab_size), 0.01)
        if cfg.encdec:
            params["enc_blocks"] = self._init_dense_block(init.stacked(cfg.enc_layers), cfg.d_ff)
            params["dec_blocks"] = self._init_xblock(init.stacked(cfg.num_layers))
            return params
        n_scan = cfg.num_layers - cfg.n_dense_layers
        if cfg.n_dense_layers:
            params["prefix"] = [
                self._init_dense_block(init, cfg.dense_ff or cfg.d_ff)
                for _ in range(cfg.n_dense_layers)
            ]
        params["blocks"] = self._init_block(init.stacked(n_scan))
        if cfg.family == "hybrid":
            params["shared_attn"] = self._init_shared_attn(init)
        return params

    def param_count(self, active_only: bool = False) -> int:
        shapes = self.init(None, device="meta")
        total = sum(x.numel() for x in _leaves(shapes))
        cfg = self.cfg
        if active_only and cfg.moe is not None:
            m = cfg.moe
            n_moe_layers = cfg.num_layers - cfg.n_dense_layers
            per_expert = 3 * cfg.d_model * m.expert_ff
            routed = n_moe_layers * m.num_experts * per_expert
            active_routed = n_moe_layers * m.top_k * per_expert
            total = total - routed + active_routed
        return total

    # -------------------------------------------------------------- blocks
    def _remat(self, fn, *args):
        """fn(*args); under `cfg.remat`, while autograd records, its
        activations are recomputed in the backward instead of kept."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def _block_fwd(self, p, h, positions):
        """One block of the main stack (Mamba2, or attention + MLP / MoE)."""
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid"):
            out, _ = S.apply_mamba(p["mamba"], cfg, L.rms_norm(h, p["ln"], cfg.rmsnorm_eps))
            return h + out
        hn = L.rms_norm(h, p["ln1"], cfg.rmsnorm_eps)
        if cfg.mla is not None:
            a, _, _ = L.apply_mla(p["attn"], cfg, hn, positions)
        else:
            a, _ = L.apply_attention(p["attn"], cfg, hn, positions, causal=cfg.causal)
        h = h + a
        hn = L.rms_norm(h, p["ln2"], cfg.rmsnorm_eps)
        if cfg.family == "moe":
            B, Sq, d = hn.shape
            out = L.reshape(M.apply_moe(p["moe"], cfg, L.reshape(hn, B * Sq, d)), B, Sq, d)
        else:
            out = L.apply_mlp(p["mlp"], hn, cfg.mlp_type)
        return h + out

    def _dense_block_fwd(self, p, h, positions, *, causal=True, kv=None):
        """Attention + plain MLP block (prefix layers, encoder blocks)."""
        cfg = self.cfg
        hn = L.rms_norm(h, p["ln1"], cfg.rmsnorm_eps)
        if cfg.mla is not None:
            a, _, _ = L.apply_mla(p["attn"], cfg, hn, positions)
            kv_out = None
        else:
            a, kv_out = L.apply_attention(
                p["attn"], cfg, hn, positions, causal=causal, kv=kv
            )
        h = h + a
        hn = L.rms_norm(h, p["ln2"], cfg.rmsnorm_eps)
        return h + L.apply_mlp(p["mlp"], hn, cfg.mlp_type), kv_out

    def _shared_attn_fwd(self, p, h, positions):
        """The hybrid's shared attention + MLP block; returns (h, (k, v))."""
        cfg = self.cfg
        hn = L.rms_norm(h, p["ln1"], cfg.rmsnorm_eps)
        a, kv = L.apply_attention(p["attn"], cfg, hn, positions, causal=True)
        h = h + a
        hn = L.rms_norm(h, p["ln2"], cfg.rmsnorm_eps)
        return h + L.apply_mlp(p["mlp"], hn, cfg.mlp_type), kv

    def _embed(self, params, tokens):
        if hasattr(params["embed"], "placements"):
            return L.embed_on_shards(params["embed"], tokens).to(_dtype(self.cfg))
        return params["embed"][tokens.long()].to(_dtype(self.cfg))

    # ------------------------------------------------------------- forward
    def _stack(self, params, h, positions):
        """The main block stack over hidden states h [B,S,d]; the hybrid's
        shared block after every `attn_period`-th layer."""
        cfg = self.cfg
        shared = params.get("shared_attn")

        def body(p, hh, idx):
            hh = self._block_fwd(p, hh, positions)
            if cfg.family == "hybrid" and cfg.attn_period and (idx + 1) % cfg.attn_period == 0:
                hh, _ = self._shared_attn_fwd(shared, hh, positions)
            return self._c(hh)

        n_scan = cfg.num_layers - cfg.n_dense_layers
        for i, p in enumerate(_unstack(params["blocks"], n_scan)):
            h = self._remat(body, p, h, i)
        return h

    def hidden_states(self, params, tokens, extra_embeds=None):
        """Token (+frontend) embedding -> block stack -> final norm."""
        cfg = self.cfg
        h = self._embed(params, tokens)
        if extra_embeds is not None:  # vlm/audio stub: precomputed embeddings
            h = torch.cat([extra_embeds.to(_dtype(cfg)), h], dim=1)
        B, Sq, _ = h.shape
        h = self._c(h)
        positions = torch.arange(Sq, device=h.device).expand(B, Sq)
        fwd = lambda pp, hh: self._c(self._dense_block_fwd(pp, hh, positions)[0])
        for p in params.get("prefix", []):
            h = self._remat(fwd, p, h)
        h = self._stack(params, h, positions)
        return L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)

    def logits(self, params, h):
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return L.dense_mm(h, w.to(h.dtype))

    def loss(self, params, batch: dict) -> torch.Tensor:
        """batch: tokens [B,S], labels [B,S] (-100 = ignore), optional
        'embeds' [B,P,d] frontend stub (labels then cover P+S positions),
        tensors on the params' device.  Differentiable in the fp32 masters."""
        params = self._lowp(params)
        if self.cfg.encdec:
            return self._encdec_loss(params, batch)
        h = self.hidden_states(params, batch["tokens"], batch.get("embeds"))
        logits = self._c(self.logits(params, h))  # [B, S/tp, V]: seq-sharded
        return _nll(logits, batch["labels"])

    # --------------------------------------------------------- encoder-decoder
    def _encode(self, params, embeds):
        cfg = self.cfg
        h = embeds.to(_dtype(cfg))
        B, Sq, _ = h.shape
        positions = torch.arange(Sq, device=h.device).expand(B, Sq)
        body = lambda p, hh: self._c(self._dense_block_fwd(p, hh, positions, causal=False)[0])
        for p in _unstack(params["enc_blocks"], cfg.enc_layers):
            h = self._remat(body, p, h)
        return h

    def _decode_stack(self, params, h, positions, memory):
        cfg = self.cfg

        def body(p, hh):
            hn = L.rms_norm(hh, p["ln1"], cfg.rmsnorm_eps)
            a, _ = L.apply_attention(p["attn"], cfg, hn, positions, causal=True)
            hh = hh + a
            hn = L.rms_norm(hh, p["ln_x"], cfg.rmsnorm_eps)
            mem_k, mem_v = self._cross_kv(p, memory)
            a, _ = L.apply_attention(p["xattn"], cfg, hn, positions, kv=(mem_k, mem_v))
            hh = hh + a
            hn = L.rms_norm(hh, p["ln2"], cfg.rmsnorm_eps)
            return self._c(hh + L.apply_mlp(p["mlp"], hn, cfg.mlp_type))

        for p in _unstack(params["dec_blocks"], cfg.num_layers):
            h = self._remat(body, p, h)
        return h

    def _cross_kv(self, p, memory):
        cfg = self.cfg
        B, Sm, _ = memory.shape
        K, Dh = cfg.num_kv_heads, cfg.head_dim
        k = L.reshape(L.apply_dense(p["xattn"]["wk"], memory), B, Sm, K, Dh)
        v = L.reshape(L.apply_dense(p["xattn"]["wv"], memory), B, Sm, K, Dh)
        return k, v

    def _encdec_loss(self, params, batch):
        cfg = self.cfg
        memory = self._encode(params, batch["embeds"])
        h = self._embed(params, batch["tokens"])
        B, Sq, _ = h.shape
        positions = torch.arange(Sq, device=h.device).expand(B, Sq)
        h = self._decode_stack(params, h, positions, memory)
        h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
        return _nll(self._c(self.logits(params, h)), batch["labels"])

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, seq: int, dtype=None, *, device="cuda") -> dict:
        cfg = self.cfg
        dev = _device(device)
        if dtype is None:
            dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else torch.bfloat16
        z = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
        K, Dh = cfg.num_kv_heads, cfg.head_dim
        n_scan = cfg.num_layers - cfg.n_dense_layers
        if cfg.encdec:
            return {
                "self_k": z((cfg.num_layers, batch, seq, K, Dh)),
                "self_v": z((cfg.num_layers, batch, seq, K, Dh)),
                # cross K/V filled at prefill from the encoder memory
                "cross_k": z((cfg.num_layers, batch, seq, K, Dh)),
                "cross_v": z((cfg.num_layers, batch, seq, K, Dh)),
            }
        int8 = dtype == torch.int8
        if cfg.family in ("ssm", "hybrid"):
            s = cfg.ssm
            H = s.num_heads(cfg.d_model)
            conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.state_dim
            out = {
                "h": z((n_scan, batch, H, s.head_dim, s.state_dim), torch.float32),
                "conv": z((n_scan, batch, s.conv_width - 1, conv_dim),
                          torch.bfloat16 if int8 and cfg.family == "hybrid" else dtype),
            }
            if cfg.family == "ssm":
                return out
            n_attn = n_scan // cfg.attn_period
            out["attn_k"] = z((n_attn, batch, seq, K, Dh))
            out["attn_v"] = z((n_attn, batch, seq, K, Dh))
            if int8:
                out["attn_k_scale"] = z((n_attn, batch, seq, K), torch.bfloat16)
                out["attn_v_scale"] = z((n_attn, batch, seq, K), torch.bfloat16)
            return out
        if cfg.mla is not None:
            r = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            cache = {"latent": z((n_scan, batch, seq, r),
                                 torch.bfloat16 if int8 else dtype)}
        else:
            cache = {
                "k": z((n_scan, batch, seq, K, Dh)),
                "v": z((n_scan, batch, seq, K, Dh)),
            }
            if int8:
                cache["k_scale"] = z((n_scan, batch, seq, K), torch.bfloat16)
                cache["v_scale"] = z((n_scan, batch, seq, K), torch.bfloat16)
        if cfg.n_dense_layers:
            if cfg.mla is not None:
                r = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
                cache["prefix_latent"] = z((cfg.n_dense_layers, batch, seq, r))
            else:
                cache["prefix_k"] = z((cfg.n_dense_layers, batch, seq, K, Dh))
                cache["prefix_v"] = z((cfg.n_dense_layers, batch, seq, K, Dh))
        return cache

    def decode_step(self, params, tokens, pos, cache):
        """One-token decode. tokens [B,1], pos an int (or 0-dim tensor).
        Returns (logits, cache), the cache's tensors updated in place."""
        cfg = self.cfg
        pos = int(pos)
        params = self._lowp(params)
        if cfg.encdec:
            return self._encdec_decode_step(params, tokens, pos, cache)
        h = self._embed(params, tokens)
        cache = dict(cache)

        for i, p in enumerate(params.get("prefix", [])):
            hn = L.rms_norm(h, p["ln1"], cfg.rmsnorm_eps)
            if cfg.mla is not None:
                a, _ = L.apply_mla_decode(
                    p["attn"], cfg, hn, pos, {"latent": cache["prefix_latent"][i]})
            else:
                lc = {"k": cache["prefix_k"][i], "v": cache["prefix_v"][i]}
                a, _ = L.apply_attention_decode(p["attn"], cfg, hn, pos, lc)
            h = h + a
            hn = L.rms_norm(h, p["ln2"], cfg.rmsnorm_eps)
            h = h + L.apply_mlp(p["mlp"], hn, cfg.mlp_type)

        if cfg.family in ("ssm", "hybrid"):
            h = self._ssm_decode_scan(params, h, pos, cache)
        else:
            h = self._attn_decode_scan(params, h, pos, cache)
        h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
        return self.logits(params, h), cache

    def _attn_decode_scan(self, params, h, pos, cache):
        cfg = self.cfg
        quant = cfg.kv_cache_dtype == "int8" and cfg.mla is None
        n_scan = cfg.num_layers - cfg.n_dense_layers
        for i, p in enumerate(_unstack(params["blocks"], n_scan)):
            hn = L.rms_norm(h, p["ln1"], cfg.rmsnorm_eps)
            if cfg.mla is not None:
                a, _ = L.apply_mla_decode(p["attn"], cfg, hn, pos, {"latent": cache["latent"][i]})
            else:
                names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
                lc = {n: cache[n][i] for n in names}
                a, _ = L.apply_attention_decode(p["attn"], cfg, hn, pos, lc)
            h = h + a
            hn = L.rms_norm(h, p["ln2"], cfg.rmsnorm_eps)
            if cfg.family == "moe":
                B = hn.shape[0]
                out = L.reshape(M.apply_moe(p["moe"], cfg, L.reshape(hn, B, -1)), B, 1, -1)
            else:
                out = L.apply_mlp(p["mlp"], hn, cfg.mlp_type)
            h = h + out
        return h

    def _mamba_decode(self, p, h, cache, i):
        cfg = self.cfg
        hn = L.rms_norm(h, p["ln"], cfg.rmsnorm_eps)
        out, c2 = S.apply_mamba_decode(
            p["mamba"], cfg, hn, {"h": cache["h"][i], "conv": cache["conv"][i]})
        _set_layer(cache["h"], i, c2["h"])
        _set_layer(cache["conv"], i, c2["conv"])
        return h + out

    def _ssm_decode_scan(self, params, h, pos, cache):
        cfg = self.cfg
        n_scan = cfg.num_layers - cfg.n_dense_layers
        layers = _unstack(params["blocks"], n_scan)
        if cfg.family != "hybrid":
            for i, p in enumerate(layers):
                h = self._mamba_decode(p, h, cache, i)
            return h
        # hybrid: groups of attn_period mamba layers, each followed by one
        # shared-attn application with its own (per-application) KV slot.
        period = cfg.attn_period
        quant = cfg.kv_cache_dtype == "int8"
        names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
        sp = params["shared_attn"]
        for g in range(n_scan // period):
            for i in range(g * period, (g + 1) * period):
                h = self._mamba_decode(layers[i], h, cache, i)
            lc = {n: cache["attn_" + n][g] for n in names}
            hn = L.rms_norm(h, sp["ln1"], cfg.rmsnorm_eps)
            a, _ = L.apply_attention_decode(sp["attn"], cfg, hn, pos, lc)
            h = h + a
            hn = L.rms_norm(h, sp["ln2"], cfg.rmsnorm_eps)
            h = h + L.apply_mlp(sp["mlp"], hn, cfg.mlp_type)
        return h

    def _encdec_decode_step(self, params, tokens, pos, cache):
        cfg = self.cfg
        h = self._embed(params, tokens)
        for i, p in enumerate(_unstack(params["dec_blocks"], cfg.num_layers)):
            hn = L.rms_norm(h, p["ln1"], cfg.rmsnorm_eps)
            a, _ = L.apply_attention_decode(
                p["attn"], cfg, hn, pos, {"k": cache["self_k"][i], "v": cache["self_v"][i]})
            h = h + a
            hn = L.rms_norm(h, p["ln_x"], cfg.rmsnorm_eps)
            B = hn.shape[0]
            q = L.reshape(L.apply_dense(p["xattn"]["wq"], hn),
                          B, 1, cfg.num_heads, cfg.head_dim)
            ck, cv = cache["cross_k"][i], cache["cross_v"][i]
            a = L.decode_attention(q, ck, cv, ck.shape[1] - 1)
            a = L.apply_dense(p["xattn"]["wo"], L.reshape(a, B, 1, -1))
            h = h + a
            hn = L.rms_norm(h, p["ln2"], cfg.rmsnorm_eps)
            h = h + L.apply_mlp(p["mlp"], hn, cfg.mlp_type)
        h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
        return self.logits(params, h), dict(cache)

    def prefill(self, params, batch, max_seq: Optional[int] = None):
        """Prefill: full forward pass + cache population.

        Returns (last-position logits, cache).  For encdec: encode the memory
        and precompute cross K/V.  Attention families compute K/V per layer
        to fill the cache (single pass, no decode loop).  `max_seq` pads
        cache seq dims with headroom for subsequent decode.
        """
        cfg = self.cfg
        dt = _dtype(cfg)
        params = self._lowp(params)
        if cfg.encdec:
            memory = self._encode(params, batch["embeds"])
            B, Sm, _ = memory.shape
            kv = [self._cross_kv(p, memory)
                  for p in _unstack(params["dec_blocks"], cfg.num_layers)]
            shape = (cfg.num_layers, B, Sm, cfg.num_kv_heads, cfg.head_dim)
            cache = {
                "self_k": torch.zeros(shape, dtype=dt, device=memory.device),
                "self_v": torch.zeros(shape, dtype=dt, device=memory.device),
                "cross_k": torch.stack([k for k, _ in kv]).to(dt),
                "cross_v": torch.stack([v for _, v in kv]).to(dt),
            }
            tokens = batch["tokens"]  # decoder BOS prompt [B, 1]
            h = self._embed(params, tokens)
            positions = torch.zeros_like(tokens)
            h = self._decode_stack(params, h, positions, memory)
            h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
            return self.logits(params, h), cache

        if cfg.family in ("ssm", "hybrid"):
            logits, cache = self._ssm_prefill(params, batch)
            if "attn_k" in cache:
                cache["attn_k"] = _pad_seq(cache["attn_k"], max_seq)
                cache["attn_v"] = _pad_seq(cache["attn_v"], max_seq)
            return logits, cache

        h = self._embed(params, batch["tokens"])
        extra = batch.get("embeds")
        if extra is not None:
            h = torch.cat([extra.to(dt), h], dim=1)
        B, Sq, _ = h.shape
        positions = torch.arange(Sq, device=h.device).expand(B, Sq)

        def block_with_cache(p, hh, dense: bool = False):
            hn = L.rms_norm(hh, p["ln1"], cfg.rmsnorm_eps)
            if cfg.mla is not None:
                a, latent, k_rope = L.apply_mla(p["attn"], cfg, hn, positions)
                entry = (torch.cat([latent, k_rope[:, :, 0, :]], dim=-1).to(dt),)
            else:
                a, (k, v) = L.apply_attention(
                    p["attn"], cfg, hn, positions, causal=cfg.causal
                )
                entry = (k.to(dt), v.to(dt))
            hh = hh + a
            hn = L.rms_norm(hh, p["ln2"], cfg.rmsnorm_eps)
            if cfg.family == "moe" and not dense:
                out = L.reshape(M.apply_moe(p["moe"], cfg, L.reshape(hn, B * Sq, -1)), B, Sq, -1)
            else:
                out = L.apply_mlp(p["mlp"], hn, cfg.mlp_type)
            return self._c(hh + out), entry

        prefix = []
        for p in params.get("prefix", []):
            h, entry = block_with_cache(p, h, dense=True)
            prefix.append(entry)
        entries = []
        for p in _unstack(params["blocks"], cfg.num_layers - cfg.n_dense_layers):
            h, entry = block_with_cache(p, h)
            entries.append(entry)
        stack = lambda es, j: torch.stack([e[j] for e in es])
        cache: dict[str, Any] = {}
        if cfg.mla is not None:
            cache["latent"] = stack(entries, 0)
            if prefix:
                cache["prefix_latent"] = stack(prefix, 0)
        else:
            cache["k"], cache["v"] = stack(entries, 0), stack(entries, 1)
            if prefix:
                cache["prefix_k"], cache["prefix_v"] = stack(prefix, 0), stack(prefix, 1)
        cache = {k: _pad_seq(v, max_seq) for k, v in cache.items()}
        h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
        return self.logits(params, h[:, -1:, :]), cache

    def _ssm_prefill(self, params, batch):
        cfg = self.cfg
        dt = _dtype(cfg)
        h = self._embed(params, batch["tokens"])
        B, Sq, _ = h.shape
        positions = torch.arange(Sq, device=h.device).expand(B, Sq)
        hybrid = cfg.family == "hybrid" and cfg.attn_period
        hs, conv, attn_k, attn_v = [], [], [], []
        for i, p in enumerate(_unstack(params["blocks"], cfg.num_layers)):
            hn = L.rms_norm(h, p["ln"], cfg.rmsnorm_eps)
            out, (h_fin, conv_tail) = S.apply_mamba(p["mamba"], cfg, hn)
            h = h + out
            hs.append(h_fin)
            conv.append(conv_tail.to(dt))
            # the reference computes zeros for the other layers' slots and
            # keeps only the populated shared-attn slots
            if hybrid and (i + 1) % cfg.attn_period == 0:
                h, (k, v) = self._shared_attn_fwd(params["shared_attn"], h, positions)
                attn_k.append(k.to(dt))
                attn_v.append(v.to(dt))
            h = self._c(h)
        cache: dict[str, Any] = {"h": torch.stack(hs), "conv": torch.stack(conv)}
        if cfg.family == "hybrid":
            cache["attn_k"], cache["attn_v"] = torch.stack(attn_k), torch.stack(attn_v)
        h = L.rms_norm(h, params["final_norm"], cfg.rmsnorm_eps)
        return self.logits(params, h[:, -1:, :]), cache
