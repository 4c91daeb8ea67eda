"""Synthetic matching-LP instances (paper Appendix A), bucketed-ELL packing,
and O(delta) delta ingestion for recurring solves."""
from repro_torch.instances.buckets import (
    SLAB_DTYPES,
    Bucket,
    BucketedInstance,
    bucketize,
    convert_bucket,
    dequantize_bucket,
    pack_single_slab,
    pack_source_ids,
    resolve_slab_dtype,
    rhs_dtype,
    slab_dtype_name,
    unpack_primal,
)
from repro_torch.instances.deltas import (
    BucketScatter,
    DeltaIngestor,
    DeltaReport,
    InstanceDelta,
    ScatterPlan,
    apply_delta_to_edge_list,
)
from repro_torch.instances.generator import (
    EdgeListInstance,
    MatchingInstanceSpec,
    generate_matching_instance,
)

__all__ = [
    "SLAB_DTYPES",
    "resolve_slab_dtype",
    "rhs_dtype",
    "slab_dtype_name",
    "MatchingInstanceSpec",
    "generate_matching_instance",
    "EdgeListInstance",
    "Bucket",
    "BucketedInstance",
    "bucketize",
    "convert_bucket",
    "dequantize_bucket",
    "pack_single_slab",
    "pack_source_ids",
    "unpack_primal",
    "InstanceDelta",
    "DeltaReport",
    "BucketScatter",
    "ScatterPlan",
    "DeltaIngestor",
    "apply_delta_to_edge_list",
]
