"""Synthetic matching-LP instances (paper Appendix A) and bucketed-ELL packing."""
from repro_torch.instances.buckets import (
    SLAB_DTYPES,
    Bucket,
    BucketedInstance,
    bucketize,
    convert_bucket,
    dequantize_bucket,
    pack_single_slab,
    resolve_slab_dtype,
    rhs_dtype,
    slab_dtype_name,
    unpack_primal,
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
    "unpack_primal",
]
