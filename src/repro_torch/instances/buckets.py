"""Bucketed-ELL packing of matching LPs, as tensors (port of `repro.instances.buckets`).

Sources whose eligible-degree d lies in (2^{t-1}, 2^t] are packed into a dense
slab of width L_t = 2^t (the paper's §4.1 compact storage and §4.2 length
bucketing in one structure).  Layout per bucket (n rows = sources, L = width):

  idx   [n, L] int32  destination id of each eligible edge (0 for padding)
  coeff [m, n, L]     constraint coefficient per family    (0 for padding)
  cost  [n, L]        minimisation cost c_ij               (0 for padding)
  mask  [n, L]        1 for real edges, 0 for padding

Packing is host-side numpy, step for step as the reference does it, so the
same edge list gives bit-identical slabs in both packages; the slabs move to
the requested device at the end.  Slab storage is float32 (default),
bfloat16 or int8.  numpy has no bfloat16, so narrow slabs are torch tensors
from the point of conversion on.  int8 slabs carry symmetric per-bucket
scales, `coeff_scale [m, 1, 1]` and `cost_scale [1, 1]` (fp32); value =
q * scale.  The rhs and the duals stay fp32 for every slab dtype.

The reference keeps the packing bookkeeping (needed by `unpack_primal`) in a
registry keyed by `id()`; here it rides on the instance as `pack_info`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.instances.generator import EdgeListInstance

__all__ = [
    "Bucket",
    "BucketedInstance",
    "PackInfo",
    "SLAB_DTYPES",
    "bucketize",
    "convert_bucket",
    "dequantize_bucket",
    "pack_single_slab",
    "pack_source_ids",
    "resolve_slab_dtype",
    "rhs_dtype",
    "slab_dtype_name",
    "unpack_primal",
]

SLAB_DTYPES = ("float32", "bfloat16", "int8")
_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}

_INT8_QMAX = 127.0  # symmetric quantization range [-127, 127]


def slab_dtype_name(dtype) -> str:
    """Canonical name ("float32" | "bfloat16" | "int8") of a slab dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def resolve_slab_dtype(dtype) -> torch.dtype:
    """Canonical torch dtype of a slab-dtype name/dtype (raises on unknown)."""
    name = slab_dtype_name(dtype)
    if name not in SLAB_DTYPES:
        raise ValueError(
            f"unsupported slab dtype {dtype!r}; choose from {SLAB_DTYPES}"
        )
    return _TORCH_DTYPES[name]


def rhs_dtype(slab_dtype) -> torch.dtype:
    """Storage dtype of the rhs: dual space stays fp32 when slabs go narrow."""
    d = resolve_slab_dtype(slab_dtype)
    return d if d == torch.float32 else torch.float32


@dataclasses.dataclass
class Bucket:
    idx: torch.Tensor  # [n, L] int32
    coeff: torch.Tensor  # [m, n, L] slab dtype
    cost: torch.Tensor  # [n, L] slab dtype
    mask: torch.Tensor  # [n, L] slab dtype (exact 0/1 in any dtype)
    length: int
    # int8 storage only: symmetric per-bucket dequantization scales, fp32
    coeff_scale: Optional[torch.Tensor] = None  # [m, 1, 1]
    cost_scale: Optional[torch.Tensor] = None  # [1, 1]

    @property
    def rows(self) -> int:
        return int(self.idx.shape[0])

    @property
    def slab_dtype(self) -> str:
        return slab_dtype_name(self.coeff.dtype)

    def to(self, device) -> "Bucket":
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, idx=move(self.idx), coeff=move(self.coeff),
            cost=move(self.cost), mask=move(self.mask),
            coeff_scale=move(self.coeff_scale), cost_scale=move(self.cost_scale),
        )


@dataclasses.dataclass
class PackInfo:
    """Host-side bookkeeping to map packed slabs back to edge order."""

    # per bucket: source id per row (-1 pad), edge offset of each row's slice
    source_ids: list[np.ndarray]
    edge_starts: list[np.ndarray]
    degrees: list[np.ndarray]


@dataclasses.dataclass
class BucketedInstance:
    buckets: tuple[Bucket, ...]
    rhs: torch.Tensor  # [m * J] f32
    num_sources: int
    num_destinations: int
    num_families: int
    # set by `bucketize`; None for instances built by `repro_torch.convert`
    pack_info: Optional[PackInfo] = None
    # the compiled formulation (`repro_torch.formulation.FormulationSpec`)
    # that `MatchingObjective` resolves; None is the matching formulation.
    # `dataclasses.replace` keeps it, so it rides through `normalize_rows`,
    # `shard_instance` and `to`
    formulation: Optional[object] = None

    @property
    def dual_dim(self) -> int:
        return self.num_families * self.num_destinations

    @property
    def device(self) -> torch.device:
        return self.rhs.device

    @property
    def nnz(self) -> int:
        return int(sum(float(b.mask.float().sum()) for b in self.buckets))

    @property
    def slab_dtype(self) -> str:
        return self.buckets[0].slab_dtype

    def row_norms_sq(self) -> np.ndarray:
        """||A_r||_2^2 per coupling row r = k*J + j (for Jacobi / Lemma B.1)."""
        m, J = self.num_families, self.num_destinations
        out = np.zeros(m * J)
        for b in self.buckets:
            idx = _host(b.idx)
            coeff, _, mask = _host_dequant(b)
            for k in range(m):
                np.add.at(out, k * J + idx.ravel(), (coeff[k] ** 2 * mask).ravel())
        return out

    def to(self, device) -> "BucketedInstance":
        return dataclasses.replace(
            self,
            buckets=tuple(b.to(device) for b in self.buckets),
            rhs=self.rhs.to(device),
        )


# -- host-side helpers --------------------------------------------------------


def _host(t) -> np.ndarray:
    """numpy view of a tensor (bfloat16 widened to float32, exactly)."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _host_dequant(b: Bucket) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(coeff, cost, mask) of one bucket as fp32 numpy arrays (host side)."""
    coeff, cost, mask = _host(b.coeff), _host(b.cost), _host(b.mask)
    if b.slab_dtype == "float32":
        return coeff, cost, mask
    coeff = coeff.astype(np.float32)
    cost = cost.astype(np.float32)
    mask = mask.astype(np.float32)
    if b.coeff_scale is not None:
        coeff = coeff * _host(b.coeff_scale).astype(np.float32)
    if b.cost_scale is not None:
        cost = cost * _host(b.cost_scale).astype(np.float32)
    return coeff, cost, mask


def _quantize_sym(values: np.ndarray, axes: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization over `axes`: (q, scale) with q = round(v/s)
    clipped to [-127, 127] and s = max|v| / 127 (1/127 when all-zero, so the
    padding invariant q == 0 on mask-zero slots is preserved exactly)."""
    amax = np.abs(values).max(axis=axes, keepdims=True).astype(np.float32)
    scale = np.where(amax > 0, amax, 1.0) / _INT8_QMAX
    q = np.clip(np.rint(values / scale), -_INT8_QMAX, _INT8_QMAX)
    return q.astype(np.int8), scale


def convert_bucket(b: Bucket, dtype) -> Bucket:
    """Conversion of one fp32 bucket to a storage dtype (host arithmetic).

    bf16: plain round-to-nearest-even cast of coeff/cost/mask.  int8:
    symmetric per-bucket quantization (per family for coeff) with fp32
    scales; mask stores its exact 0/1 pattern as int8.  fp32 -> unchanged.
    The result lives on the input bucket's device.
    """
    name = slab_dtype_name(resolve_slab_dtype(dtype))
    if name == b.slab_dtype and b.coeff_scale is None:
        return b
    if b.slab_dtype != "float32":
        raise ValueError("convert_bucket expects an fp32 source bucket")
    device = b.idx.device
    coeff, cost, mask = _host(b.coeff), _host(b.cost), _host(b.mask)
    if name == "bfloat16":
        bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16).to(device)
        return dataclasses.replace(
            b, coeff=bf16(coeff), cost=bf16(cost), mask=bf16(mask)
        )
    q_coeff, coeff_scale = _quantize_sym(coeff, axes=(1, 2))
    q_cost, cost_scale = _quantize_sym(cost[None], axes=(1, 2))
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dataclasses.replace(
        b,
        coeff=dev(q_coeff),
        cost=dev(q_cost[0]),
        mask=dev(mask.astype(np.int8)),
        coeff_scale=dev(coeff_scale.astype(np.float32)),
        cost_scale=dev(cost_scale[0].astype(np.float32)),
    )


def dequantize_bucket(b: Bucket) -> Bucket:
    """fp32 compute view of one bucket; fp32 storage returns `b` itself."""
    if b.slab_dtype == "float32":
        return b
    coeff, cost, mask = b.coeff.float(), b.cost.float(), b.mask.float()
    if b.coeff_scale is not None:
        coeff = coeff * b.coeff_scale
    if b.cost_scale is not None:
        cost = cost * b.cost_scale
    return dataclasses.replace(
        b, coeff=coeff, cost=cost, mask=mask, coeff_scale=None, cost_scale=None
    )


# ---------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _pad_rows(n: int, multiple: int) -> int:
    return int(math.ceil(max(n, 1) / multiple) * multiple)


def bucketize(
    inst: EdgeListInstance,
    *,
    shard_multiple: int = 1,
    min_length: int = 1,
    max_length: Optional[int] = None,
    dtype="float32",
    device="cuda",
) -> BucketedInstance:
    """Pack an edge list into the bucketed-ELL layout on `device`.

    Edges in ``inst`` must be sorted by (source, destination), as the
    generator guarantees.  ``shard_multiple`` pads every bucket's row count
    to a multiple of it.  ``dtype`` is the slab storage dtype; slabs are
    packed in fp32 and converted per bucket, and the rhs stays fp32.
    """
    dev = resolve_device(device)
    slab_dt = resolve_slab_dtype(dtype)
    spec = inst.spec
    I, J, m = spec.num_sources, spec.num_destinations, spec.num_families

    deg = np.bincount(inst.src, minlength=I)
    active = np.flatnonzero(deg)  # sources with at least one edge
    if active.size == 0:
        raise ValueError("instance has no edges")
    starts = np.zeros(I + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])

    max_deg = int(deg.max())
    cap = _next_pow2(max_deg)
    if max_length is not None and cap > max_length:
        raise ValueError(
            f"max degree {max_deg} exceeds max bucket length {max_length}"
        )
    lengths = []
    L = max(1, _next_pow2(min_length))
    cap = max(cap, L)
    while L <= cap:
        lengths.append(L)
        L *= 2
    # bucket index per active source: smallest L >= degree, but >= min length
    b_of = np.searchsorted(np.asarray(lengths), deg[active])

    buckets: list[Bucket] = []
    info = PackInfo(source_ids=[], edge_starts=[], degrees=[])
    for t, Lt in enumerate(lengths):
        rows_src = active[b_of == t]
        n = _pad_rows(rows_src.size, shard_multiple)
        idx = np.zeros((n, Lt), dtype=np.int32)
        coeff = np.zeros((m, n, Lt), dtype=np.float32)
        cost = np.zeros((n, Lt), dtype=np.float32)
        mask = np.zeros((n, Lt), dtype=np.float32)
        d = deg[rows_src]
        st = starts[rows_src]
        if rows_src.size:
            r = np.repeat(np.arange(rows_src.size), d)
            o = np.concatenate([np.arange(k) for k in d]) if d.size else np.empty(0, int)
            e = np.repeat(st, d) + o
            idx[r, o] = inst.dst[e]
            cost[r, o] = inst.cost[e]
            mask[r, o] = 1.0
            for k in range(m):
                coeff[k, r, o] = inst.coeff[k, e]
        host = Bucket(
            idx=torch.from_numpy(idx), coeff=torch.from_numpy(coeff),
            cost=torch.from_numpy(cost), mask=torch.from_numpy(mask), length=Lt,
        )
        buckets.append(convert_bucket(host, slab_dt).to(dev))
        sid = np.full(n, -1, dtype=np.int64)
        sid[: rows_src.size] = rows_src
        info.source_ids.append(sid)
        info.edge_starts.append(st)
        info.degrees.append(d)

    rhs = torch.from_numpy(inst.rhs.astype(np.float32)).to(rhs_dtype(slab_dt))
    return BucketedInstance(
        buckets=tuple(buckets),
        rhs=rhs.to(dev),
        num_sources=I,
        num_destinations=J,
        num_families=m,
        pack_info=info,
    )


def pack_single_slab(
    inst: EdgeListInstance, *, shard_multiple: int = 1, dtype="float32",
    device="cuda",
) -> BucketedInstance:
    """The paper's `batching=False` baseline: one slab of width next_pow2(s_max)."""
    deg = np.bincount(inst.src, minlength=inst.spec.num_sources)
    width = _next_pow2(int(deg.max()))
    return bucketize(
        inst, shard_multiple=shard_multiple, min_length=width, dtype=dtype,
        device=device,
    )


def pack_source_ids(packed: BucketedInstance) -> list[np.ndarray]:
    """Per-bucket source id of each slab row (-1 for padded rows), copies.

    Only available for instances produced by `bucketize` (their
    `pack_info`); the delta-ingest layer (`repro_torch.instances.deltas`)
    uses it to seed its row-occupancy maps.
    """
    info = packed.pack_info
    if info is None:
        raise KeyError("pack_source_ids: packing info not found for this instance")
    return [a.copy() for a in info.source_ids]


def unpack_primal(
    packed: BucketedInstance, x_slabs: Sequence[torch.Tensor | np.ndarray]
) -> np.ndarray:
    """Scatter per-bucket primal slabs back to edge order (sorted by src,dst)."""
    info = packed.pack_info
    if info is None:
        raise KeyError("unpack_primal: packing info not found for this instance")
    nnz = int(sum(d.sum() for d in info.degrees))
    x_edges = np.zeros(nnz)
    for bi, slab in enumerate(x_slabs):
        slab = _host(slab)
        d = info.degrees[bi]
        st = info.edge_starts[bi]
        if d.size == 0:
            continue
        r = np.repeat(np.arange(d.size), d)
        o = np.concatenate([np.arange(k) for k in d])
        e = np.repeat(st, d) + o
        x_edges[e] = slab[r, o]
    return x_edges
