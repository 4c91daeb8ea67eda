"""End-to-end LM training with the fault-tolerant loop, on the PyTorch port
(port of examples/train_lm.py).

Default: a ~10M-param qwen3-family model for 200 steps.
--preset 100m trains a ~100M-param model (same pipeline, longer wall time).
Demonstrates: data pipeline, AdamW, checkpoint/resume (kill it mid-run and
restart — it continues from the last checkpoint).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--preset 10m] [--device cpu]

The reference's flags and defaults, plus `--device` (default cuda, which
raises without a card), with one exception: the checkpoint directory
defaults to /tmp/repro_torch_train_lm, not the reference's
/tmp/repro_train_lm.  Checkpoints cross between the two packages, so a
shared default would make a run of one silently resume the other's.  The
params come from a torch generator seeded 0 on the device, unless `run` is
given `state=`; the batches from `SyntheticLMData(seed=0)`.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Optional

from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.training.loop import TrainLoopConfig, train_loop
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainState

PRESETS = {
    "10m": ModelConfig(
        name="qwen3-10m", family="dense", num_layers=4, d_model=256,
        num_heads=8, num_kv_heads=4, d_ff=1024, vocab_size=8192,
        qk_norm=True, remat=False,
    ),
    "100m": ModelConfig(
        name="qwen3-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
        qk_norm=True, remat=False,
    ),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python examples/train_lm_torch.py")
    ap.add_argument("--preset", default="10m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


@dataclasses.dataclass
class Trained:
    """What the run printed and logged."""

    param_count: int
    state: TrainState
    losses: dict  # step -> loss, at every logged step


def run(args, *, state: Optional[TrainState] = None) -> Trained:
    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    model = Model(cfg)
    n = model.param_count()
    print(f"model: {cfg.name}  params={n:,}")
    data = SyntheticLMData(cfg, batch=args.batch, seq=args.seq, seed=0)
    loop_cfg = TrainLoopConfig(total_steps=args.steps, save_every=50, log_every=10)
    losses = {}

    def on_step(k: int, metrics: dict) -> None:
        if (k + 1) % loop_cfg.log_every == 0:
            losses[k + 1] = float(metrics["loss"])

    state = train_loop(
        model,
        data,
        AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        loop_cfg,
        ckpt_dir=args.ckpt_dir,
        state=state,
        on_step=on_step,
        device=dev,
    )
    print(f"finished at step {int(state.step)}; checkpoints in {args.ckpt_dir}")
    return Trained(n, state, losses)


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
