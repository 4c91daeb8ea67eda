"""Process-group set-up for the sharded solve (the solver part of
`repro.launch.mesh`).

One process per card.  Under torchrun the rank, world size and rendezvous
come from its environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); otherwise the caller passes `init_method` (`file://<path>` or
`tcp://localhost:<port>`), `rank` and `world_size`.  Each process takes
`cuda:LOCAL_RANK` (its rank when LOCAL_RANK is not set) unless the device
names a card itself.  The backend follows the device: NCCL for CUDA, gloo
for the CPU.

    torchrun --nproc_per_node 4 -m repro_torch.launch.solve --shards 4 ...
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as tdist

from repro_torch.device import resolve_device

__all__ = ["local_device", "setup", "teardown", "under_torchrun"]


def under_torchrun() -> bool:
    """Whether torchrun (or another launcher) set the rendezvous variables."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def setup(
    device="cuda",
    *,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.device:
    """Join the process group and return this process's device.

    `backend` overrides the device's own (NCCL for CUDA, gloo for the CPU);
    it exists for running several processes on one card over gloo.
    """
    dev = resolve_device(device)
    if init_method is None:
        if not under_torchrun():
            raise RuntimeError(
                "no process group to join: run under torchrun, or pass "
                "init_method, rank and world_size"
            )
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError("init_method needs rank and world_size")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, rank=rank, world_size=world_size,
    )
    return dev


def local_device(device="cuda") -> torch.device:
    """This process's device: the current card for a bare "cuda"."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def teardown() -> None:
    """Leave the process group, if this process is in one."""
    if tdist.is_initialized():
        tdist.destroy_process_group()
