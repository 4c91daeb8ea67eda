"""LM training CLI over the assigned architecture pool (port of
`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --reduced \
        --steps 100 --batch 8 --seq 128 [--ckpt-dir DIR]

The reference's flags and defaults, plus `--device` (default cuda, which
raises without a card; `--device cpu` runs on the CPU).  --reduced uses the
smoke-scale config; a full config's state (fp32 params, grads and two AdamW
moments: 16 bytes per parameter) must fit the device.  Params come from a
torch.Generator seeded 0 on the device, the batches from
`SyntheticLMData(seed=0)`.  With --ckpt-dir a run resumes from the latest
checkpoint there (the reference's format: either package's resumes in the
other) and saves every --save-every steps and at the end.  The AdamW
schedule spans --steps (warmup a tenth of it), as in the reference.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import Model
    from repro_torch.training.loop import TrainLoopConfig, train_loop
    from repro_torch.training.optimizer import AdamWConfig

    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg)
    print(f"{cfg.name}: {model.param_count():,} params")
    data = SyntheticLMData(cfg, batch=args.batch, seq=args.seq, seed=0)
    state = train_loop(
        model,
        data,
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps),
        TrainLoopConfig(total_steps=args.steps, save_every=args.save_every),
        ckpt_dir=args.ckpt_dir or None,
        device=args.device,
    )
    print(f"done at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
