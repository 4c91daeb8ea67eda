"""Batched serving demo on the PyTorch port: continuous-batching engine over
a small LM (port of examples/serve_lm.py).

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

`--device` defaults to cuda, which raises without a card.  The params come
from a torch generator seeded 0 on the device, unless `run` is given
`params=`; the prompts from numpy's `default_rng(0)`, as the reference's.
The step loop is the reference's: it counts engine steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.lm_demo.engine import Request, ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python examples/serve_lm_torch.py")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


@dataclasses.dataclass
class Served:
    """What the demo printed, with every request whole."""

    steps: int  # engine steps
    seconds: float  # ending on the host's copy of the last token
    done: list  # the requests in the order they finished


def run(args, *, params: Optional[dict] = None) -> Served:
    dev = resolve_device(args.device)
    cfg = get_reduced_config("qwen3-8b")
    model = Model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, params, slots=4, max_seq=96)

    rng = np.random.default_rng(0)
    prompt_len = 16
    for rid in range(8):
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32),
            max_new_tokens=24,
        ))
    t0 = time.time()
    steps = 0
    done = []
    while engine.queue or any(r is not None for r in engine.active):
        active_before = [r for r in engine.active if r is not None]
        engine.step()
        steps += 1
        for r in active_before:
            if r.done and r not in done:
                done.append(r)
    dt = time.time() - t0
    total_tokens = sum(8 * [24])
    print(f"served 8 requests x 24 tokens in {steps} engine steps, {dt:.1f}s "
          f"({total_tokens / dt:.1f} tok/s on {dev})")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out_tokens[:8]}...")
    return Served(steps, dt, done)


def main(argv: Optional[list[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
