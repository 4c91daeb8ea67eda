"""Allocation serving from device-resident duals (port of `repro.serving`).

A `DualStore` of generation-stamped per-tenant `DualSnapshot`s, published
atomically by the service layer after each cadence solve, and queried for
the requested users' rows only — O(degree) per user, bit-identical to a
direct projection against the reported generation.  A simplex tenant's
query is kernel 2 over the requested rows (one launch per query on the
card); other feasible sets take plain ops over the gathered rows.
"""
from repro_torch.serving.duals import (
    BucketAllocations,
    DualSnapshot,
    DualStore,
    QueryResult,
    compute_lam_eff,
    direct_allocations,
)

__all__ = [
    "BucketAllocations",
    "DualSnapshot",
    "DualStore",
    "QueryResult",
    "compute_lam_eff",
    "direct_allocations",
]
