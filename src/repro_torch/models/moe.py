"""Mixture-of-experts layer: sort-based grouped matmul + optional LP routing
(port of `repro.models.moe`).

Dispatch ("dropping", MaxText-style): flatten the T*k (token, expert)
assignments, sort by expert, compute each assignment's rank within its
expert, and scatter into a dense [E, C, d] buffer (assignments beyond
capacity C are dropped).  Expert FFNs then run as one batched einsum over
the stacked [E, d, ff] weights.

`router="lp"` routes with the paper's solver: token->expert assignment *is* a
regularized matching LP (tokens = sources under a top-k simplex constraint,
experts = destinations under capacity coupling constraints).  A few dual-
ascent iterations over the plain simplex projection
(`repro_torch.core.projections.project_simplex`, the one the reference
calls) produce a balanced fractional assignment.

Ties follow the reference.  `jax.lax.top_k` puts the lower index first on
ties, which `lp_route`'s exact zeros make certain; a stable descending sort
does the same (`torch.topk` promises no order).  The argsort is stable, the
segment starts are `side="left"`, and the capacity rounds half to even
(Python's `round`).  The combine adds each token's k contributions in the
order the reference's CPU scatter-add does (sorted by expert, starting from
zero), one elementwise add per slot: no atomics, so the card's result is the
same in every run.

Over a mesh (x a DTensor), dispatch and combine have no DTensor sharding
rule (argsort, searchsorted, index_put, the combine's gathers): the tokens
and the router's weight are made whole on every rank (`Replicate`) and
routed there as plain tensors, the same on every rank; the expert FFNs run
as DTensor einsums over the experts' shards, and the shared experts over
the tokens' own placement.
"""
from __future__ import annotations

import torch

from repro_torch.core.projections import project_simplex
from repro_torch.models.layers import ParamInit, apply_dense, apply_mlp, init_dense, init_mlp

__all__ = ["init_moe", "apply_moe", "lp_route", "top_k"]


def init_moe(init: ParamInit, cfg) -> dict:
    m = cfg.moe
    d = cfg.d_model
    std = 0.02
    p = {
        "router": init_dense(init, d, m.num_experts),
        "w_gate": init.normal((m.num_experts, d, m.expert_ff), std),
        "w_up": init.normal((m.num_experts, d, m.expert_ff), std),
        "w_down": init.normal((m.num_experts, m.expert_ff, d), std),
    }
    if m.num_shared > 0:
        p["shared"] = init_mlp(init, d, m.num_shared * m.expert_ff)
    return p


def lp_route(
    probs: torch.Tensor,  # [T, E] router probabilities
    top_k: int,
    capacity: float,  # per-expert capacity (same units as sum of x)
    *,
    iters: int = 16,
    gamma: float = 0.1,
) -> torch.Tensor:
    """Balanced fractional assignment via the paper's regularized dual ascent.

    LP:  max_x sum_te probs_te x_te - (gamma/2)||x||^2
         s.t. sum_e x_te <= k (per token; simplex radius k),
              sum_t x_te <= capacity (per expert; coupling constraints).

    The coupling matrix is a Def.-1 matching matrix with one family and unit
    coefficients; A^T lam is a broadcast and A x a column sum, so the dual-
    ascent iteration runs entirely on the [T, E] tile.  Returns the
    fractional assignment x (callers take top-k of x).
    """
    T, E = probs.shape
    probs = probs.to(torch.float32)
    mask = torch.ones_like(probs)
    # analytic step size: sigma_max(A)^2 <= T (unit column sums over T tokens)
    eta = gamma / torch.tensor(T, dtype=torch.float32, device=probs.device)
    b = torch.tensor(capacity, dtype=torch.float32, device=probs.device)
    lam = torch.zeros((E,), dtype=torch.float32, device=probs.device)
    for _ in range(iters):
        # x*(lam) = Pi_simplex_k( (probs - lam) / gamma ) ; cost c = -probs
        z = (probs - lam[None, :]) / gamma
        x = project_simplex(z, mask, radius=float(top_k))
        grad = torch.sum(x, dim=0) - b  # A x - b  (per-expert load)
        # jnp.maximum's subgradient: half to each side at a tie
        lam = torch.maximum(lam + eta * grad, torch.zeros_like(lam))
    z = (probs - lam[None, :]) / gamma
    return project_simplex(z, mask, radius=float(top_k))


def apply_moe(p, cfg, x2d: torch.Tensor) -> torch.Tensor:
    """x2d: [T, d] -> [T, d].

    With `cfg.moe.groups > 0` the token set splits into that many groups and
    dispatch (argsort, rank, scatter) runs per group (the reference vmaps
    it); groups=0 is the single global dispatch.
    """
    if hasattr(x2d, "placements"):
        return _apply_moe_on_mesh(p, cfg, x2d)
    return _apply_moe(p, cfg, x2d)


def _apply_moe(p, cfg, x2d, mesh=None, shared=True):
    m = cfg.moe
    T, d = x2d.shape
    G = m.groups
    if G > 1 and T % G == 0 and T // G >= m.top_k:
        xg = x2d.reshape(G, T // G, d)
        return torch.stack([_moe_one_group(p, cfg, xs, mesh, shared)
                            for xs in xg]).reshape(T, d)
    return _moe_one_group(p, cfg, x2d, mesh, shared)


def _apply_moe_on_mesh(p, cfg, x2d):
    """The named place where MoE routing leaves DTensor: tokens and router
    weight replicated, routing local (see the module's docstring)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x2d.device_mesh
    rep = [Replicate()] * mesh.ndim
    x = x2d.redistribute(mesh, rep).to_local()
    local = dict(p, router={k: v.full_tensor() for k, v in p["router"].items()})
    out = DTensor.from_local(_apply_moe(local, cfg, x, mesh, shared=False), mesh, rep,
                             run_check=False)
    if cfg.moe.num_shared > 0:
        out = out + apply_mlp(p["shared"], x2d)
    return out


def top_k(probs: torch.Tensor, k: int):
    """`jax.lax.top_k`: the k largest per row, the lower index first on ties."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def _moe_one_group(p, cfg, x2d: torch.Tensor, mesh=None, shared=True) -> torch.Tensor:
    m = cfg.moe
    T, d = x2d.shape
    E, k = m.num_experts, m.top_k
    C = int(max(1, round(T * k / E * m.capacity_factor)))
    dev = x2d.device

    logits = apply_dense(p["router"], x2d).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    if m.router == "lp":
        probs = lp_route(probs, k, capacity=C, iters=m.lp_iters, gamma=m.lp_gamma)
    weights, ids = top_k(probs, k)  # [T, k]
    weights = (weights / torch.clamp_min(
        torch.sum(weights, dim=-1, keepdim=True), 1e-9
    )).to(x2d.dtype)

    # ---- sort-based dispatch ------------------------------------------------
    flat_e = ids.reshape(-1)  # [T*k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev), side="left")
    rank = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    keep = rank < C
    token_of = order // k
    dest = torch.where(keep, sorted_e * C + rank, E * C)  # overflow -> scratch row
    buf = torch.zeros((E * C + 1, d), dtype=x2d.dtype, device=dev)
    buf[dest] = x2d[token_of]  # only the discarded scratch row takes duplicates
    h = buf[: E * C].reshape(E, C, d)

    # ---- batched expert FFN -------------------------------------------------
    y = _experts(p, h, mesh)

    # ---- combine -------------------------------------------------------------
    y_flat = torch.cat([y.reshape(E * C, d), torch.zeros((1, d), dtype=y.dtype, device=dev)])
    contrib = y_flat[dest] * weights.reshape(-1)[order][:, None]  # [T*k, d], sorted order
    # the reference adds contributions into out[token] in sorted order; a
    # token's k experts are distinct, so that is its slots by ascending expert
    slot_of = torch.empty_like(order)
    slot_of[order] = torch.arange(T * k, device=dev)  # assignment -> sorted position
    by_expert = torch.sort(ids, dim=-1, stable=True).indices  # [T, k]
    pos = torch.gather(slot_of.reshape(T, k), 1, by_expert)
    out = torch.zeros((T, d), dtype=x2d.dtype, device=dev)
    for j in range(k):
        out = out + contrib[pos[:, j]]

    if shared and m.num_shared > 0:
        out = out + apply_mlp(p["shared"], x2d)
    return out


def _experts(p, h: torch.Tensor, mesh=None) -> torch.Tensor:
    """The batched expert FFN over the dispatch buffer h [E, C, d]; over a
    mesh, DTensor einsums against the experts' shards, the result made
    whole on every rank."""
    def ff(w):
        return w.to(h.dtype)

    if mesh is not None:
        from torch.distributed.tensor import DTensor, Replicate

        h = DTensor.from_local(h, mesh, [Replicate()] * mesh.ndim, run_check=False)
    g = torch.einsum("ecd,edf->ecf", h, ff(p["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", h, ff(p["w_up"]))
    y = torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(g) * u, ff(p["w_down"]))
    return y.full_tensor() if mesh is not None else y
