"""Logical parameter/activation sharding rules (Megatron TP + optional FSDP;
port of `repro.training.sharding_rules`).

Rules are keyed on the *owning* weight name in the param tree path (the
parent of the "w"/"b" leaf), classifying each 2D/3D weight as column-parallel
(output dim on the tp axis) or row-parallel (input dim on the tp axis); FSDP
additionally shards the complementary dim over the dp axes.  Stacked params
([L, ...]) keep the leading layer dim unsharded.

Dims that do not divide the mesh axis size silently drop that axis
(`maybe_shard`) - e.g. starcoder2's 36 heads on a 16-way tp axis fall back to
sharding the flattened H*Dh projection dim, and mamba2's 50280-row vocab
stays replicated.

A spec is the reference's `PartitionSpec` as a plain tuple, one entry per
tensor dim: None (replicated), one mesh axis name, or a tuple of axis names
(a 1-tuple is written as its name, as `PartitionSpec` normalises it).  The
rules read only the mesh's axis sizes, so any object whose `shape` maps axis
names to sizes will do (a `DeviceMesh` is read through `mesh_dim_names`).
`placements` turns a spec into DTensor placements on a `DeviceMesh`: a dim
sharded over several axes is `Shard(dim)` on each of their mesh dims, which
DTensor splits in mesh-dim order, i.e. major to minor as JAX does, provided
the spec lists the axes in mesh order (the rules' dp axes ("pod", "data")
do).
"""
from __future__ import annotations

import math
from typing import Union

from repro_torch.models.config import ModelConfig, ShardingProfile

__all__ = [
    "maybe_shard",
    "param_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "named",
    "placements",
    "distribute",
    "axis_sizes",
]

# column-parallel: output feature dim sharded on tp
_COL = {
    "wq", "wk", "wv", "w_gate", "w_up", "wq_a", "wq_b", "wkv_a", "wkv_b",
    "in_proj", "router",
}
# row-parallel: input feature dim sharded on tp
_ROW = {"wo", "w_down", "out_proj"}

_STACKS = ("blocks", "enc_blocks", "dec_blocks")
_KV_NAMES = ("k", "v", "self_k", "self_v", "cross_k", "cross_v",
             "attn_k", "attn_v", "prefix_k", "prefix_v")


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, or of a mesh whose `shape` is
    such a mapping (the reference's `Mesh` and `AbstractMesh`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, axes: Union[str, tuple]) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def _norm(axes):
    """A 1-tuple of axes as its name, as `PartitionSpec` stores it."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def maybe_shard(dim: int, axes, mesh):
    """axes if dim divides their product, else None (replicated dim).  An
    axis the mesh lacks (the tp axis of a 1-D `make_host_mesh`) replicates
    the dim too, where the reference's lookup would fail."""
    if axes is None:
        return None
    if any(a not in axis_sizes(mesh) for a in ((axes,) if isinstance(axes, str) else axes)):
        return None
    size = _axis_size(mesh, axes)
    return _norm(axes) if dim % size == 0 else None


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        out = [_tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(path, tree)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and type(x) is tuple and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _keys(path) -> list[str]:
    """The dict keys of a path (list indices, the reference's SequenceKeys,
    dropped)."""
    return [k for k in path if isinstance(k, str)]


def _owner(path) -> str:
    """Owning weight name: parent key of a 'w'/'b' leaf, else the leaf key."""
    keys = _keys(path)
    if not keys:
        return ""
    if keys[-1] in ("w", "b") and len(keys) >= 2:
        return keys[-2]
    return keys[-1]


def _in_stack(path) -> bool:
    return any(k in _STACKS for k in _keys(path))


def param_pspecs(params_shape, mesh, profile: ShardingProfile) -> dict:
    """Spec tree for a param tree (pass `Model.init(None, device="meta")`)."""
    tp = profile.tp_axis
    dp = tuple(profile.dp_axes) if profile.fsdp else None

    def rule(path, leaf):
        name = _owner(path)
        shape = tuple(leaf.shape)
        off = 1 if _in_stack(path) else 0
        nd = len(shape) - off
        lead = (None,) * off
        if name == "embed":  # [V, d]
            return (maybe_shard(shape[0], tp, mesh),
                    maybe_shard(shape[1], dp, mesh) if dp else None)
        if name == "lm_head":  # [d, V]
            return (maybe_shard(shape[0], dp, mesh) if dp else None,
                    maybe_shard(shape[1], tp, mesh))
        if nd == 3 and name in ("w_gate", "w_up", "w_down"):  # experts [E, ., .]
            return (*lead,
                    maybe_shard(shape[off], tp, mesh),
                    maybe_shard(shape[off + 1], dp, mesh) if dp else None,
                    None)
        if nd == 2 and name in _COL:
            return (*lead,
                    maybe_shard(shape[off], dp, mesh) if dp else None,
                    maybe_shard(shape[off + 1], tp, mesh))
        if nd == 2 and name in _ROW:
            return (*lead,
                    maybe_shard(shape[off], tp, mesh),
                    maybe_shard(shape[off + 1], dp, mesh) if dp else None)
        if nd == 2 and name == "conv_w":  # [W, C] depthwise conv
            return (*lead, None, maybe_shard(shape[off + 1], tp, mesh))
        # norms, biases, scalars: replicated (beyond the stack dim)
        return (*lead, *((None,) * nd))

    return _tree_map_with_path(rule, params_shape)


def batch_pspecs(batch_shape, profile: ShardingProfile, mesh) -> dict:
    """Shard every batch input on its leading (batch) dim over the dp axes."""
    dp = tuple(profile.dp_axes)

    def rule(path, leaf):
        if leaf.ndim == 0:
            return ()
        return (maybe_shard(leaf.shape[0], dp, mesh), *((None,) * (leaf.ndim - 1)))

    return _tree_map_with_path(rule, batch_shape)


def cache_pspecs(cache_shape, cfg: ModelConfig, profile: ShardingProfile, mesh) -> dict:
    """KV/state cache sharding for serving.

    Layout [L, B, S, K, Dh] (attention) / [L, B, ...] (ssm states): batch over
    dp; the cache *sequence* dim over tp (GQA kv-head counts rarely divide a
    16-way tp axis).  Decode attention over a sequence-sharded cache is then
    a distributed softmax combine, which DTensor carries.
    """
    tp = profile.tp_axis
    dp = tuple(profile.dp_axes)

    def rule(path, leaf):
        keys = _keys(path)
        name = keys[-1] if keys else ""
        sh = tuple(leaf.shape)
        if name in _KV_NAMES:  # [L, B, S, K, Dh]
            return (None, maybe_shard(sh[1], dp, mesh),
                    maybe_shard(sh[2], tp, mesh), None, None)
        if name in ("latent", "prefix_latent"):  # [L, B, S, r]
            return (None, maybe_shard(sh[1], dp, mesh),
                    maybe_shard(sh[2], tp, mesh), None)
        if name.endswith("_scale"):  # int8 cache scales [L, B, S, K]
            return (None, maybe_shard(sh[1], dp, mesh),
                    maybe_shard(sh[2], tp, mesh), None)
        if name == "h":  # ssm state [L, B, H, P, N]
            return (None, maybe_shard(sh[1], dp, mesh),
                    maybe_shard(sh[2], tp, mesh), None, None)
        if name == "conv":  # [L, B, W-1, conv_dim]
            return (None, maybe_shard(sh[1], dp, mesh), None,
                    maybe_shard(sh[3], tp, mesh))
        return (None,) * leaf.ndim

    return _tree_map_with_path(rule, cache_shape)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements on `mesh` (a `DeviceMesh`) of one spec."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's "
                             f"order {tuple(names)}; DTensor splits in mesh order")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def named(mesh, tree):
    """Spec tree -> DTensor placements tree on `mesh` (the reference's
    `NamedSharding` tree)."""
    return _tree_map_with_path(lambda _, s: placements(s, mesh), tree)


def distribute(x, mesh, pl: tuple):
    """The DTensor on `mesh` with placements `pl` whose global value is `x`
    (the same full tensor on every rank), each rank keeping its shard: no
    communication.  Shards are cut as DTensor cuts them (`torch.chunk`
    sizes, in mesh-dim order) and copied, so the full tensor can be freed;
    with nothing sharded the tensor is used as it is."""
    from torch.distributed.tensor import DTensor, Shard

    local = x
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n, size = mesh.size(i), local.shape[p.dim]
            chunk = -(-size // n)
            start = min(coord[i] * chunk, size)
            local = local.narrow(p.dim, start, min(chunk, size - start))
    if local is not x:
        local = local.clone()
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=x.shape,
                              stride=x.stride())
