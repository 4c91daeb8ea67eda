"""Fault-tolerant training loop: checkpoint/resume, bounded retry, preemption
(port of `repro.training.loop`).

The loop composes the substrate pieces:
  * resume: restores the latest checkpoint and *skips ahead* in the
    deterministic data pipeline (batch k is a pure function of k);
  * periodic + final checkpoints via the atomic async CheckpointManager, in
    the reference's format (a checkpoint of either package resumes in the
    other);
  * bounded retry around the step (transient-failure tolerance, an
    out-of-memory error included, as in the reference);
  * SIGTERM -> synchronous save -> clean exit (preemption handling).  The
    step updates the state in place, so a SIGTERM that arrives during a step
    is held until the step is whole, and the save then writes that state.

Batches come from the pipeline as numpy and move to the loop's device here.

Over a mesh (`mesh=`, `profile=`: every rank of the running group calls the
loop), the step is `make_train_step`'s sharded one and the state is sharded
by the rules.  A checkpoint holds the full tensors, gathered on save (a
collective) and written by rank 0, so the single-device loop and the
reference read it; a resume reads it on every rank and shards it again.
The SIGTERM save and the save after a step's last failed retry are the
single-device loop's only: over a mesh each needs every rank's gather,
which a signal handler or a failing rank cannot promise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import signal
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, latest_step
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (
    TrainState,
    gather_state,
    init_sharded_state,
    init_train_state,
    make_train_step,
)

log = logging.getLogger("repro_torch.train")

__all__ = ["TrainLoopConfig", "train_loop", "batch_to_device"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 200
    save_every: int = 50
    keep: int = 3
    max_retries: int = 2
    log_every: int = 10


def batch_to_device(batch: dict, device) -> dict:
    """A pipeline batch (numpy arrays) as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@contextlib.contextmanager
def _sigterm_held(active: bool):
    """Hold a SIGTERM back for the duration of the block, then deliver it to
    the handler that was installed (the checkpoint manager's save hook)."""
    if not active:
        yield
        return
    got = []
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: got.append(signum))
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)
        if got:
            signal.raise_signal(signal.SIGTERM)


def train_loop(
    model: Model,
    data: SyntheticLMData,
    opt_cfg: AdamWConfig,
    loop_cfg: TrainLoopConfig,
    ckpt_dir: Optional[str] = None,
    *,
    mesh=None,
    profile=None,
    state: Optional[TrainState] = None,
    step_fn: Optional[Callable] = None,
    on_step: Optional[Callable[[int, dict], None]] = None,
    device="cuda",
) -> TrainState:
    dev = resolve_device(device)
    if step_fn is None:
        step_fn, _, _ = make_train_step(model, opt_cfg, mesh, profile)
    writer = mesh is None or torch.distributed.get_rank() == 0
    sigterm = mesh is None

    mgr = (
        CheckpointManager(ckpt_dir, keep=loop_cfg.keep, save_on_sigterm=sigterm)
        if ckpt_dir
        else None
    )
    start = 0
    if state is None:
        state = init_train_state(model, device=dev)
        if mesh is not None:
            state = init_sharded_state(model, mesh, profile, state=state)
    if mgr is not None:
        last = latest_step(ckpt_dir)
        if last is not None:
            # a sharded state's leaves give the global shapes and dtypes
            state = mgr.restore(last, state, device=dev)
            if mesh is not None:
                state = init_sharded_state(model, mesh, profile, state=state)
            start = last
            log.info("resumed from step %d", last)
        if sigterm:
            mgr.attach_state_provider(lambda: (int(state.step), state))

    def save(step: int, block: bool = False) -> None:
        full = gather_state(state) if mesh is not None else state
        if writer:
            mgr.save(step, full, block=block)

    t0 = time.time()
    for k in range(start, loop_cfg.total_steps):
        batch = batch_to_device(data(k), dev)
        for attempt in range(loop_cfg.max_retries + 1):
            try:
                with _sigterm_held(mgr is not None and sigterm):
                    state, metrics = step_fn(state, batch)
                break
            except Exception:  # bounded retry on transient failure
                if attempt == loop_cfg.max_retries:
                    if mgr and mesh is None:
                        save(k, block=True)
                    raise
                log.exception("step %d failed (attempt %d); retrying", k, attempt)
        if on_step is not None:
            on_step(k, metrics)
        if loop_cfg.log_every and (k + 1) % loop_cfg.log_every == 0:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            log.info("step %d loss %.4f (%.2fs)", k + 1, loss, dt)
        if mgr and (k + 1) % loop_cfg.save_every == 0:
            save(k + 1)
    if mgr:
        save(loop_cfg.total_steps, block=True)
        mgr.wait()
    return state
