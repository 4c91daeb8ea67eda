"""Port parity: instance generation and bucketed-ELL packing, against the JAX package.

The port must pack the same edge list into bit-identical slabs
(array_equal) for every slab dtype, so both packages solve the same LP.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch

from repro.core.objective import normalize_rows as jax_normalize_rows
from repro.instances import buckets as jbk
from repro.instances import generator as jgen
from repro_torch import convert
from repro_torch.core.objective import normalize_rows
from repro_torch.instances import buckets as tbk
from repro_torch.instances import generator as tgen

DTYPES = ["float32", "bfloat16", "int8"]


def _bits(a) -> np.ndarray:
    """Array as comparable bits: bf16 (ml_dtypes or torch) as uint16."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_instance(got, want):
    assert len(got.buckets) == len(want.buckets)
    for bt, bj in zip(got.buckets, want.buckets):
        assert bt.length == bj.length
        for name in ("idx", "coeff", "cost", "mask", "coeff_scale", "cost_scale"):
            a, b = getattr(bt, name), getattr(bj, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert _bits(a).dtype == _bits(b).dtype, name
                np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    np.testing.assert_array_equal(_bits(got.rhs), _bits(want.rhs))
    assert (got.num_sources, got.num_destinations, got.num_families) == (
        want.num_sources, want.num_destinations, want.num_families
    )


def _spec(mod, seed=3, m=2):
    return mod.MatchingInstanceSpec(
        num_sources=250, num_destinations=30, avg_degree=6.0,
        num_families=m, seed=seed,
    )


@pytest.mark.parametrize("seed,m", [(0, 1), (3, 2), (11, 3)])
def test_generator_edge_lists_equal(seed, m):
    got = tgen.generate_matching_instance(_spec(tgen, seed, m))
    want = jgen.generate_matching_instance(_spec(jgen, seed, m))
    for name in ("src", "dst", "values", "coeff", "rhs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("dtype", DTYPES)
def test_bucketize_and_normalize_slabs_equal(dtype):
    edges_t = tgen.generate_matching_instance(_spec(tgen))
    edges_j = jgen.generate_matching_instance(_spec(jgen))
    packed_t = tbk.bucketize(edges_t, dtype=dtype, device="cpu")
    packed_j = jbk.bucketize(edges_j, dtype=dtype)
    _assert_same_instance(packed_t, packed_j)
    np.testing.assert_array_equal(packed_t.row_norms_sq(), packed_j.row_norms_sq())
    scaled_t, d_t = normalize_rows(packed_t)
    scaled_j, d_j = jax_normalize_rows(packed_j)
    np.testing.assert_array_equal(d_t, d_j)
    _assert_same_instance(scaled_t, scaled_j)


def test_bucketize_shard_multiple_and_single_slab():
    edges_t = tgen.generate_matching_instance(_spec(tgen))
    edges_j = jgen.generate_matching_instance(_spec(jgen))
    _assert_same_instance(
        tbk.bucketize(edges_t, shard_multiple=4, device="cpu"),
        jbk.bucketize(edges_j, shard_multiple=4),
    )
    _assert_same_instance(
        tbk.pack_single_slab(edges_t, device="cpu"),
        jbk.pack_single_slab(edges_j),
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_convert_bucket_equal(dtype):
    rng = np.random.default_rng(5)
    n, L, m = 13, 8, 3
    mask = (rng.random((n, L)) < 0.7).astype(np.float32)
    idx = (rng.integers(0, 40, size=(n, L)) * mask).astype(np.int32)
    coeff = (rng.normal(size=(m, n, L)) * mask).astype(np.float32)
    cost = (rng.normal(size=(n, L)) * mask).astype(np.float32)
    bj = jbk.convert_bucket(
        jbk.Bucket(idx=idx, coeff=coeff, cost=cost, mask=mask, length=L), dtype
    )
    bt = tbk.convert_bucket(
        tbk.Bucket(idx=torch.from_numpy(idx), coeff=torch.from_numpy(coeff),
                   cost=torch.from_numpy(cost), mask=torch.from_numpy(mask),
                   length=L),
        dtype,
    )
    for name in ("coeff", "cost", "mask", "coeff_scale", "cost_scale"):
        a, b = getattr(bt, name), getattr(bj, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    # fp32 compute views agree too
    dt, dj = tbk.dequantize_bucket(bt), jbk.dequantize_bucket(bj)
    for name in ("coeff", "cost", "mask"):
        np.testing.assert_array_equal(
            getattr(dt, name).numpy(), np.asarray(getattr(dj, name))
        )


def test_unpack_primal_round_trip():
    edges = tgen.generate_matching_instance(_spec(tgen))
    packed = tbk.bucketize(edges, device="cpu")
    # slabs holding each edge's cost come back as the edge-order cost vector
    x = tbk.unpack_primal(packed, [b.cost for b in packed.buckets])
    np.testing.assert_array_equal(x, edges.cost.astype(np.float32))
    packed_j = jbk.bucketize(jgen.generate_matching_instance(_spec(jgen)))
    want = jbk.unpack_primal(packed_j, [np.asarray(b.cost) for b in packed_j.buckets])
    np.testing.assert_array_equal(x, want)
    assert packed.nnz == packed_j.nnz == edges.nnz


@pytest.mark.parametrize("dtype", DTYPES)
def test_convert_matches_port_packing(dtype):
    edges_j = jgen.generate_matching_instance(_spec(jgen))
    packed_j, _ = jax_normalize_rows(jbk.bucketize(edges_j, dtype=dtype))
    got = convert.instance_from_reference(packed_j, device="cpu")
    want, _ = normalize_rows(
        tbk.bucketize(tgen.generate_matching_instance(_spec(tgen)),
                      dtype=dtype, device="cpu")
    )
    _assert_same_instance(got, packed_j)
    _assert_same_instance(want, packed_j)
    with pytest.raises(KeyError):
        tbk.unpack_primal(got, [b.cost for b in got.buckets])


def test_default_device_is_cuda():
    """The entry points default to the card and refuse to run without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    edges = tgen.generate_matching_instance(_spec(tgen))
    with pytest.raises(RuntimeError, match="cuda"):
        tbk.bucketize(edges)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.lam_from_numpy(np.zeros(3))
