"""LP-routed MoE on the PyTorch port: the paper's solver as a balanced
token->expert router (port of examples/lp_moe_routing.py).

Token->expert assignment IS a matching LP (tokens = sources under a top-k
simplex constraint, experts = destinations under capacity constraints), so a
few regularized dual-ascent iterations produce a BASE-layers-style balanced
routing.  This demo compares expert load balance and drop rate between the
standard top-k router and the LP router on the same logits.

    PYTHONPATH=src python examples/lp_moe_routing_torch.py [--device cpu]

`--device` defaults to cuda, which raises without a card.  The logits and
tokens come from numpy's `default_rng(0)`, as the reference's; the reduced
kimi model's params from a torch generator seeded 0 on the device, unless
`run` is given `params=`.  `top_k` (the MoE layer's) breaks ties by the
lower index, as `jax.lax.top_k` does: `lp_route`'s output has exact ties
(zeros, and equal capped values), on which `torch.topk` promises no order.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.moe import lp_route, top_k


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python examples/lp_moe_routing_torch.py")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def load_stats(ids, weights, E, C):
    load = np.bincount(ids.cpu().numpy(), minlength=E).astype(np.float64)
    drop = float(np.maximum(load - C, 0).sum() / max(load.sum(), 1))
    return load, drop


@dataclasses.dataclass
class Routing:
    """What the demo printed, with the loads whole."""

    capacity: int
    load_top: np.ndarray  # [E] assignments per expert, top-k router
    drop_top: float
    load_lp: np.ndarray  # [E] assignments per expert, LP router
    drop_lp: float
    loss: float  # the reduced kimi model's loss with router="lp"


def run(args, *, params: Optional[dict] = None) -> Routing:
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    T, E, k = 4096, 16, 2
    C = int(T * k / E * 1.25)
    # skewed router logits: a few "hot" experts (the pathological case)
    hot = rng.normal(size=E) * 2.0
    logits = rng.normal(size=(T, E)).astype(np.float32) + hot[None, :]
    probs = torch.softmax(torch.as_tensor(logits, device=dev), dim=-1)

    w_top, id_top = top_k(probs, k)
    load_top, drop_top = load_stats(id_top.reshape(-1), w_top, E, C * 1.0)

    x = lp_route(probs, k, capacity=float(C), iters=64, gamma=0.05)
    w_lp, id_lp = top_k(x, k)
    load_lp, drop_lp = load_stats(id_lp.reshape(-1), w_lp, E, C * 1.0)

    print(f"tokens={T} experts={E} top_k={k} capacity/expert={C}")
    print(f"top-k router : max load {load_top.max():.0f}  "
          f"imbalance {load_top.max() / load_top.mean():.2f}x  "
          f"dropped {drop_top:.1%}")
    print(f"LP router    : max load {load_lp.max():.0f}  "
          f"imbalance {load_lp.max() / load_lp.mean():.2f}x  "
          f"dropped {drop_lp:.1%}")
    assert load_lp.max() <= load_top.max() + 1e-6

    # and inside a real MoE model: flip the reduced kimi config to router="lp"
    cfg = get_reduced_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, router="lp", lp_iters=16)
    )
    model = Model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)), dtype=torch.int32,
                           device=dev)
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        loss = float(model.loss(params, batch))
    print(f"kimi-k2 (reduced) with router='lp': loss={loss:.4f} (finite OK)")
    return Routing(C, load_top, drop_top, load_lp, drop_lp, loss)


def main(argv: Optional[list[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
