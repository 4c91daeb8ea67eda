"""LM-demo serving CLI: batched request engine over a reduced arch config
(port of `repro.launch.serve_lm`).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-8b \
        --requests 8 --max-new 24

The reference's flags and defaults, plus `--device` (default cuda, which
raises without a card; `--device cpu` runs on the CPU).  Params come from a
torch.Generator seeded 0 on the device, the prompts from numpy's
`default_rng(0)`, as the reference's.  The allocation-serving CLI (duals,
not tokens) is `repro_torch.launch.serve`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_lm")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


@dataclasses.dataclass
class ServeLMRun:
    """What one run did, for callers that drive the CLI in process."""

    cfg: object  # the ModelConfig served
    requests: list  # every Request, in submission order
    seconds: float  # the engine's run, ending on the host's copy of its last token
    tokens: int  # requests x max_new


def run(args) -> ServeLMRun:
    """The CLI's run, printing what the reference prints."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models.model import Model
    from repro_torch.serving.lm_demo.engine import Request, ServeEngine

    device = resolve_device(args.device)
    cfg = get_reduced_config(args.arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(
        model, params, slots=args.slots,
        max_seq=args.prompt_len + args.max_new + 8,
    )
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
        ))
    reqs = list(engine.queue)
    t0 = time.time()
    engine.run()
    dt = time.time() - t0
    toks = args.requests * args.max_new
    print(f"{args.requests} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s)")
    return ServeLMRun(cfg, reqs, dt, toks)


def main(argv: Optional[list[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
