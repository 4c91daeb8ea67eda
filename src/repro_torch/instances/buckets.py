"""Bucketed-ELL packing of matching LPs, as tensors (port of `repro.instances.buckets`).

Sources whose eligible-degree d lies in (2^{t-1}, 2^t] are packed into a dense
slab of width L_t = 2^t (the paper's §4.1 compact storage and §4.2 length
bucketing in one structure).  Layout per bucket (n rows = sources, L = width):

  idx   [n, L] int32  destination id of each eligible edge (0 for padding)
  coeff [m, n, L]     constraint coefficient per family    (0 for padding)
  cost  [n, L]        minimisation cost c_ij               (0 for padding)
  mask  [n, L]        1 for real edges, 0 for padding

Packing runs on the device of the edge list's arrays (torch tensors, or
numpy arrays moved to `device` first) in a handful of whole-array torch
operations, with no Python loop over sources; the slabs are those of the
reference's host numpy packing bit for bit, so the same edge list gives
identical slabs in both packages.  Slab storage is float32 (default),
bfloat16 or int8; slabs are packed in fp32 and converted per bucket.  int8
slabs carry symmetric per-bucket scales, `coeff_scale [m, 1, 1]` and
`cost_scale [1, 1]` (fp32); value = q * scale.  The rhs and the duals stay
fp32 for every slab dtype.

The reference keeps the packing bookkeeping (needed by `unpack_primal`) in a
registry keyed by `id()`; here it rides on the instance as `pack_info`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
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
        """||A_r||_2^2 per coupling row r = k*J + j (for Jacobi / Lemma B.1),
        float64, summed in slot order (`core.objective.row_norms_sq`)."""
        from repro_torch.core.objective import row_norms_sq

        return row_norms_sq(self, torch.float64).cpu().numpy()

    def to(self, device) -> "BucketedInstance":
        return dataclasses.replace(
            self,
            buckets=tuple(b.to(device) for b in self.buckets),
            rhs=self.rhs.to(device),
        )


# -- helpers -----------------------------------------------------------------


def _host(t) -> np.ndarray:
    """numpy view of a tensor (bfloat16 widened to float32, exactly)."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _quantize_sym(values: torch.Tensor, dims: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of fp32 `values` over `dims`: (q, scale)
    with q = round(v/s) clipped to [-127, 127] and s = max|v| / 127 (1/127
    when all-zero, so the padding invariant q == 0 on mask-zero slots is
    preserved exactly).  fp32 arithmetic, rounding half to even: the
    reference's numpy steps, on the values' device."""
    amax = values.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax, 1.0) / _INT8_QMAX
    q = torch.clamp(torch.round(values / scale), -_INT8_QMAX, _INT8_QMAX)
    return q.to(torch.int8), scale


def convert_bucket(b: Bucket, dtype) -> Bucket:
    """Conversion of one fp32 bucket to a storage dtype, on its device.

    bf16: plain round-to-nearest-even cast of coeff/cost/mask.  int8:
    symmetric per-bucket quantization (per family for coeff) with fp32
    scales; mask stores its exact 0/1 pattern as int8.  fp32 -> unchanged.
    """
    name = slab_dtype_name(resolve_slab_dtype(dtype))
    if name == b.slab_dtype and b.coeff_scale is None:
        return b
    if b.slab_dtype != "float32":
        raise ValueError("convert_bucket expects an fp32 source bucket")
    if name == "bfloat16":
        bf16 = lambda t: t.to(torch.bfloat16)
        return dataclasses.replace(
            b, coeff=bf16(b.coeff), cost=bf16(b.cost), mask=bf16(b.mask)
        )
    q_coeff, coeff_scale = _quantize_sym(b.coeff, dims=(1, 2))
    q_cost, cost_scale = _quantize_sym(b.cost[None], dims=(1, 2))
    return dataclasses.replace(
        b,
        coeff=q_coeff,
        cost=q_cost[0],
        mask=b.mask.to(torch.int8),
        coeff_scale=coeff_scale,
        cost_scale=cost_scale[0],
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


def _on(a, device, dtype: torch.dtype) -> torch.Tensor:
    """`a` (a tensor or a numpy array) as a `dtype` tensor on `device`; the
    tensor itself where it is one already."""
    return torch.as_tensor(a).to(device=device, dtype=dtype)


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
    generator guarantees; its arrays may be numpy arrays or tensors, and are
    moved to `device` first (no copy where they are there already).
    ``shard_multiple`` pads every bucket's row count to a multiple of it.
    ``dtype`` is the slab storage dtype; slabs are packed in fp32 and
    converted per bucket, and the rhs stays fp32.

    The packing (span ``pack``, the move excluded) is whole-array work on
    `device`: the degrees by `bincount`, each source's bucket by
    `searchsorted` over the widths, its row by a stable sort on the bucket,
    and each bucket's slabs by one gather of its rows' edges (edge = the
    row's first edge + slot, live where slot < degree).  Sources keep
    ascending id order within a bucket, so the slabs and `pack_info` are the
    reference's.  Counter ``packed_slots_total{bucket=<width>}``: the slots
    written, padding included.
    """
    dev = resolve_device(device)
    slab_dt = resolve_slab_dtype(dtype)
    spec = inst.spec
    I, J, m = spec.num_sources, spec.num_destinations, spec.num_families
    src = _on(inst.src, dev, torch.int64)
    dst = _on(inst.dst, dev, torch.int64)
    values = _on(inst.values, dev, torch.float64)
    coeff = _on(inst.coeff, dev, torch.float64).reshape(m, -1)
    rhs = _on(inst.rhs, dev, torch.float64)
    with telemetry.span("pack", device=dev):
        buckets, info = _pack(src, dst, values, coeff, I, shard_multiple, min_length,
                              max_length, slab_dt)
    return BucketedInstance(
        buckets=buckets,
        rhs=rhs.to(rhs_dtype(slab_dt)),
        num_sources=I,
        num_destinations=J,
        num_families=m,
        pack_info=info,
    )


def _pack(src, dst, values, coeff, I, shard_multiple, min_length, max_length, slab_dt):
    """`bucketize`'s work on the edge list's device: (buckets, pack info)."""
    dev = src.device
    deg = torch.bincount(src, minlength=I)
    active = torch.nonzero(deg).reshape(-1)  # sources with an edge, ascending
    if active.numel() == 0:
        raise ValueError("instance has no edges")
    starts = torch.cumsum(deg, 0) - deg

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
    # bucket of each active source: smallest L >= degree, but >= min length;
    # its rows in ascending source order (a stable sort on the bucket)
    b_of = torch.searchsorted(torch.tensor(lengths, device=dev), deg[active])
    grouped = active[torch.argsort(b_of, stable=True)]
    counts = torch.bincount(b_of, minlength=len(lengths)).tolist()

    reg = telemetry.get_registry()
    buckets: list[Bucket] = []
    info = PackInfo(source_ids=[], edge_starts=[], degrees=[])
    for Lt, rows_src in zip(lengths, torch.split(grouped, counts)):
        k = rows_src.numel()
        n = _pad_rows(k, shard_multiple)
        idx = torch.zeros((n, Lt), dtype=torch.int32, device=dev)
        slab_coeff = torch.zeros((coeff.shape[0], n, Lt), dtype=torch.float32, device=dev)
        slab_cost = torch.zeros((n, Lt), dtype=torch.float32, device=dev)
        mask = torch.zeros((n, Lt), dtype=torch.float32, device=dev)
        d, st = deg[rows_src], starts[rows_src]
        if k:
            slot = torch.arange(Lt, device=dev)
            live = slot < d[:, None]  # [k, L]
            e = torch.where(live, st[:, None] + slot, 0)  # padding reads edge 0
            idx[:k] = torch.where(live, dst[e], 0)
            slab_cost[:k] = torch.where(live, -values[e], 0.0)  # cost = -value
            slab_coeff[:, :k] = torch.where(live, coeff[:, e], 0.0)
            mask[:k] = live
            del live, e
        fp32 = Bucket(idx=idx, coeff=slab_coeff, cost=slab_cost, mask=mask, length=Lt)
        buckets.append(convert_bucket(fp32, slab_dt))
        reg.inc("packed_slots_total", n * Lt, bucket=Lt)
        sid = torch.full((n,), -1, dtype=torch.int64, device=dev)
        sid[:k] = rows_src
        info.source_ids.append(sid.cpu().numpy())
        info.edge_starts.append(st.cpu().numpy())
        info.degrees.append(d.cpu().numpy())
    return tuple(buckets), info


def pack_single_slab(
    inst: EdgeListInstance, *, shard_multiple: int = 1, dtype="float32",
    device="cuda",
) -> BucketedInstance:
    """The paper's `batching=False` baseline: one slab of width next_pow2(s_max)."""
    deg = torch.bincount(torch.as_tensor(inst.src), minlength=inst.spec.num_sources)
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
    """Scatter per-bucket primal slabs back to edge order (sorted by src,dst),
    float64 on the host; the scatter runs on the slabs' device."""
    info = packed.pack_info
    if info is None:
        raise KeyError("unpack_primal: packing info not found for this instance")
    nnz = int(sum(d.sum() for d in info.degrees))
    slabs = [torch.as_tensor(x) for x in x_slabs]
    dev = slabs[0].device if slabs else torch.device("cpu")
    x_edges = torch.zeros(nnz, dtype=torch.float64, device=dev)
    for slab, d, st in zip(slabs, info.degrees, info.edge_starts):
        if d.size == 0:
            continue
        d, st = torch.from_numpy(d).to(dev), torch.from_numpy(st).to(dev)
        slot = torch.arange(slab.shape[1], device=dev)
        live = slot < d[:, None]  # the rows' real slots, row by row
        x_edges[(st[:, None] + slot)[live]] = slab[: d.numel()][live].double()
    return x_edges.cpu().numpy()
