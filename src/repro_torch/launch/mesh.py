"""Production meshes (port of `repro.launch.mesh`).

Single pod: 16 x 16 = 256 devices ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 devices ("pod", "data", "model") - the "pod"
axis is pure data parallelism; the solver's column shard flattens all axes
into one logical wafer.

A mesh is a `DeviceMesh` over the process group that is running (one rank
per device; `launch.dist.setup` joins one, or `torch.distributed`'s fake
group sizes a mesh from shapes alone).  Defined as functions, so importing
this module touches no device and joins no group.  Meshes are on the card
unless the caller asks for another device type.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ModelConfig, ShardingProfile
from repro_torch.training.sharding_rules import axis_sizes

__all__ = [
    "make_production_mesh",
    "make_host_mesh",
    "make_mesh",
    "default_profile",
    "solver_axes",
]


def make_mesh(shape: tuple, axes: tuple, device_type: str = "cuda"):
    """A `DeviceMesh` of `shape` named `axes` over the running group, whose
    world size must be the mesh's size."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    if not tdist.is_initialized():
        raise RuntimeError("a mesh spans the running process group; join one first "
                           "(launch.dist.setup)")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(n: Optional[int] = None, axis: str = "data", device_type: str = "cuda"):
    """A 1-D mesh over the group's ranks (tests run it on the CPU over gloo)."""
    import torch.distributed as tdist

    if n is None:
        n = tdist.get_world_size() if tdist.is_initialized() else 1
    return make_mesh((n,), (axis,), device_type)


def default_profile(cfg: ModelConfig, mesh) -> ShardingProfile:
    """TP for the archs below 3e10 parameters; TP+FSDP at or above it."""
    dp = ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
    big = cfg.param_count() >= 3e10
    return ShardingProfile(tp_axis="model", dp_axes=dp, fsdp=big)


def solver_axes(mesh) -> tuple[str, ...]:
    """The paper's column shard uses every mesh axis as one flat wafer."""
    return tuple(axis_sizes(mesh))
