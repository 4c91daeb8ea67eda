"""Analytic production-scale instance layouts for dry runs (port of
`repro.instances.specs`).

The dry run (`repro_torch.launch.dryrun`) sizes the solver on tensors of the
meta device, PyTorch's counterpart of `jax.ShapeDtypeStruct`: shapes and
dtypes, no storage, so no 100M-source instance is materialised.  Bucket row
counts are estimated by sampling the Appendix-A degree model at 1M sources
and scaling the histogram to the target size (padded to the shard
multiple), which keeps the padding and bucket mix that the byte and memory
model reads.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from repro_torch.instances.buckets import (
    Bucket,
    BucketedInstance,
    resolve_slab_dtype,
    rhs_dtype,
)
from repro_torch.instances.generator import MatchingInstanceSpec, generate_matching_instance

__all__ = ["production_bucket_shapes", "solver_input_specs"]

_SAMPLE = 1_000_000


@lru_cache(maxsize=16)
def _degree_fractions(avg_degree: float, breadth_sigma: float, seed: int):
    """Fraction of sources per power-of-2 bucket, sampled at 1M sources."""
    spec = MatchingInstanceSpec(
        num_sources=_SAMPLE,
        num_destinations=10_000,
        avg_degree=avg_degree,
        breadth_sigma=breadth_sigma,
        seed=seed,
    )
    inst = generate_matching_instance(spec)
    deg = np.bincount(inst.src, minlength=_SAMPLE)
    deg = deg[deg > 0]
    buckets: dict[int, int] = {}
    for d, n in zip(*np.unique(deg, return_counts=True)):
        L = 1 << max(0, int(d - 1).bit_length())
        buckets[L] = buckets.get(L, 0) + int(n)
    total = sum(buckets.values())
    return {L: n / total for L, n in sorted(buckets.items())}


def production_bucket_shapes(
    num_sources: int,
    num_destinations: int,
    num_families: int = 1,
    avg_degree: float = 10.0,
    breadth_sigma: float = 1.0,
    shard_multiple: int = 1,
    seed: int = 0,
) -> list[tuple[int, int]]:
    """[(bucket_length, padded_row_count)] for a production-size instance."""
    fr = _degree_fractions(avg_degree, breadth_sigma, seed)
    out = []
    for L, f in fr.items():
        rows = max(1, int(round(f * num_sources)))
        rows = int(math.ceil(rows / shard_multiple) * shard_multiple)
        out.append((L, rows))
    return out


def solver_input_specs(
    num_sources: int,
    num_destinations: int,
    num_families: int = 1,
    avg_degree: float = 10.0,
    shard_multiple: int = 1,
    dtype=torch.float32,
) -> BucketedInstance:
    """A `BucketedInstance` of meta-device tensors at production scale: the
    shapes and dtypes `bucketize` would give, no storage.  int8 slabs carry
    their fp32 scales, and any narrow storage keeps the rhs (and hence the
    duals) fp32, as the real layout does."""
    shapes = production_bucket_shapes(
        num_sources,
        num_destinations,
        num_families,
        avg_degree,
        shard_multiple=shard_multiple,
    )
    dtype = resolve_slab_dtype(dtype)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    quantized = dtype == torch.int8
    buckets = tuple(
        Bucket(
            idx=meta((n, L), torch.int32),
            coeff=meta((num_families, n, L), dtype),
            cost=meta((n, L), dtype),
            mask=meta((n, L), dtype),
            length=L,
            coeff_scale=meta((num_families, 1, 1), torch.float32) if quantized else None,
            cost_scale=meta((1, 1), torch.float32) if quantized else None,
        )
        for L, n in shapes
    )
    return BucketedInstance(
        buckets=buckets,
        rhs=meta((num_families * num_destinations,), rhs_dtype(dtype)),
        num_sources=num_sources,
        num_destinations=num_destinations,
        num_families=num_families,
    )
