"""Packing and Jacobi scaling as whole-array torch work, against the host
numpy loops they replaced.

`bucketize`, `unpack_primal` and `normalize_rows` now run on the device of
their inputs with no Python loop over sources.  The host forms they
replaced are kept here, step for step, as the reference: on seeded random
edge lists with empty sources, degree-1 sources, one bucket, padded row
counts and every slab dtype, the new packer gives the same slabs, rhs and
`PackInfo`, `unpack_primal` the same edge-order vector, and `normalize_rows`
the same D and scaled slabs (bitwise on the CPU, where both sum the squares
in the same order; on a card the sums' order differs, which moves D by about
1e-16 relative and a coefficient by at most one rounding).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.core.objective import normalize_rows, normalize_rows_traced
from repro_torch.instances import (
    EdgeListInstance,
    MatchingInstanceSpec,
    bucketize,
    generate_matching_instance,
    pack_single_slab,
    unpack_primal,
)

DTYPES = ["float32", "bfloat16", "int8"]


# -- the host forms that the whole-array ones replaced ------------------------


def _next_pow2(x):
    return 1 << max(0, (int(x) - 1).bit_length())


def _quantize_sym_host(values, axes):
    amax = np.abs(values).max(axis=axes, keepdims=True).astype(np.float32)
    scale = np.where(amax > 0, amax, 1.0) / 127.0
    q = np.clip(np.rint(values / scale), -127.0, 127.0)
    return q.astype(np.int8), scale


def _convert_host(coeff, cost, mask, dtype):
    """Slab arrays in the storage dtype: torch tensors (bf16 has no numpy
    dtype), with the int8 scales."""
    if dtype == "float32":
        return dict(coeff=torch.from_numpy(coeff), cost=torch.from_numpy(cost),
                    mask=torch.from_numpy(mask), coeff_scale=None, cost_scale=None)
    if dtype == "bfloat16":
        bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
        return dict(coeff=bf16(coeff), cost=bf16(cost), mask=bf16(mask),
                    coeff_scale=None, cost_scale=None)
    q_coeff, coeff_scale = _quantize_sym_host(coeff, axes=(1, 2))
    q_cost, cost_scale = _quantize_sym_host(cost[None], axes=(1, 2))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return dict(coeff=t(q_coeff), cost=t(q_cost[0]), mask=t(mask.astype(np.int8)),
                coeff_scale=t(coeff_scale.astype(np.float32)),
                cost_scale=t(cost_scale[0].astype(np.float32)))


def host_bucketize(inst, shard_multiple=1, min_length=1, dtype="float32"):
    """The per-source host packing: (per-bucket slab dicts, rhs, source ids,
    edge starts, degrees)."""
    I, m = inst.spec.num_sources, inst.spec.num_families
    deg = np.bincount(inst.src, minlength=I)
    active = np.flatnonzero(deg)
    starts = np.zeros(I + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    cap = _next_pow2(int(deg.max()))
    lengths, L = [], max(1, _next_pow2(min_length))
    cap = max(cap, L)
    while L <= cap:
        lengths.append(L)
        L *= 2
    b_of = np.searchsorted(np.asarray(lengths), deg[active])
    slabs, sids, sts, degs = [], [], [], []
    for t, Lt in enumerate(lengths):
        rows_src = active[b_of == t]
        n = int(math.ceil(max(rows_src.size, 1) / shard_multiple) * shard_multiple)
        idx = np.zeros((n, Lt), dtype=np.int32)
        coeff = np.zeros((m, n, Lt), dtype=np.float32)
        cost = np.zeros((n, Lt), dtype=np.float32)
        mask = np.zeros((n, Lt), dtype=np.float32)
        d, st = deg[rows_src], starts[rows_src]
        if rows_src.size:
            r = np.repeat(np.arange(rows_src.size), d)
            o = np.concatenate([np.arange(k) for k in d])
            e = np.repeat(st, d) + o
            idx[r, o] = inst.dst[e]
            cost[r, o] = inst.cost[e]
            mask[r, o] = 1.0
            for k in range(m):
                coeff[k, r, o] = inst.coeff[k, e]
        slabs.append(dict(idx=torch.from_numpy(idx), length=Lt,
                          **_convert_host(coeff, cost, mask, dtype)))
        sid = np.full(n, -1, dtype=np.int64)
        sid[: rows_src.size] = rows_src
        sids.append(sid)
        sts.append(st)
        degs.append(d)
    rhs = torch.from_numpy(inst.rhs.astype(np.float32))
    return slabs, rhs, sids, sts, degs


def host_unpack(degrees, edge_starts, x_slabs):
    nnz = int(sum(d.sum() for d in degrees))
    x_edges = np.zeros(nnz)
    for d, st, slab in zip(degrees, edge_starts, x_slabs):
        slab = slab.float().numpy() if slab.dtype == torch.bfloat16 else slab.numpy()
        if d.size == 0:
            continue
        r = np.repeat(np.arange(d.size), d)
        o = np.concatenate([np.arange(k) for k in d])
        x_edges[np.repeat(st, d) + o] = slab[r, o]
    return x_edges


def _host(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def host_normalize(packed, eps=1e-30):
    """The host Jacobi transform: (D, per-bucket (coeff, coeff_scale), rhs)."""
    m, J = packed.num_families, packed.num_destinations
    out = np.zeros(m * J)
    for b in packed.buckets:
        coeff, mask = _host(b.coeff).astype(np.float32), _host(b.mask).astype(np.float32)
        if b.coeff_scale is not None:
            coeff = coeff * b.coeff_scale.numpy()
        for k in range(m):
            np.add.at(out, k * J + b.idx.numpy().ravel(), (coeff[k] ** 2 * mask).ravel())
    norms = np.sqrt(out)
    d = np.where(norms > eps, 1.0 / np.maximum(norms, eps), 1.0)
    d2 = d.reshape(m, J)
    scaled = []
    for b in packed.buckets:
        scale = d2[:, b.idx.numpy()]
        if b.coeff_scale is not None:
            coeff_f32 = b.coeff.numpy().astype(np.float32) * b.coeff_scale.numpy()
            q, new_scale = _quantize_sym_host((coeff_f32 * scale).astype(np.float32), (1, 2))
            scaled.append((torch.from_numpy(q), torch.from_numpy(new_scale.astype(np.float32))))
        else:
            scaled.append((torch.from_numpy(_host(b.coeff) * scale).to(b.coeff.dtype), None))
    rhs = torch.from_numpy(packed.rhs.numpy() * d).to(packed.rhs.dtype)
    return d, scaled, rhs


# -- seeded edge lists --------------------------------------------------------


def random_edges(seed, I=300, J=40, m=2, case="mixed") -> EdgeListInstance:
    """An edge list sorted by (source, destination).  `mixed`: a third of
    the sources empty, a fifth of degree 1, a few of degree up to J; `flat`:
    every source of one degree (one bucket); `sparse`: degree 0 or 1."""
    rng = np.random.default_rng(seed)
    if case == "mixed":
        deg = rng.integers(2, 9, size=I)
        deg[rng.random(I) < 1 / 3] = 0
        deg[rng.random(I) < 1 / 5] = 1
        deg[rng.choice(I, 3, replace=False)] = rng.integers(17, J + 1, size=3)
    elif case == "flat":
        deg = np.full(I, 6)
    else:
        deg = (rng.random(I) < 0.5).astype(np.int64)
        deg[0] = 1
    src = np.repeat(np.arange(I), deg)
    dst = np.concatenate([np.sort(rng.choice(J, k, replace=False)) for k in deg])
    nnz = src.size
    values = rng.lognormal(0.0, 0.5, nnz)
    coeff = rng.lognormal(0.0, 0.5, (m, nnz)) * values
    if case == "mixed":  # a row with no coefficient: D_r = 1 there
        coeff[:, dst == 0] = 0.0
    spec = MatchingInstanceSpec(num_sources=I, num_destinations=J, num_families=m)
    return EdgeListInstance(spec=spec, src=src.astype(np.int64), dst=dst.astype(np.int64),
                            values=values, coeff=coeff, rhs=rng.uniform(1, 5, m * J))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_slabs(packed, want):
    slabs, rhs, sids, sts, degs = want
    assert [b.length for b in packed.buckets] == [s["length"] for s in slabs]
    for b, s in zip(packed.buckets, slabs):
        for name in ("idx", "coeff", "cost", "mask", "coeff_scale", "cost_scale"):
            got, exp = getattr(b, name), s[name]
            assert (got is None) == (exp is None), name
            if got is not None:
                assert got.dtype == exp.dtype and got.shape == exp.shape, name
                assert torch.equal(_bits(got), _bits(exp)), name
    assert torch.equal(packed.rhs, rhs)
    info = packed.pack_info
    for got, exp in ((info.source_ids, sids), (info.edge_starts, sts), (info.degrees, degs)):
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            assert g.dtype == np.int64 and np.array_equal(g, e)


PACK_CASES = [
    ("mixed", dict()),
    ("mixed", dict(shard_multiple=4)),
    ("mixed", dict(min_length=8)),
    ("flat", dict(shard_multiple=3, min_length=8)),  # one bucket
    ("sparse", dict()),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,kw", PACK_CASES)
def test_packer_matches_the_host_packing(case, kw, dtype):
    inst = random_edges(7, case=case)
    packed = bucketize(inst, dtype=dtype, device="cpu", **kw)
    _assert_slabs(packed, host_bucketize(inst, dtype=dtype, **kw))
    if case == "flat":
        assert len(packed.buckets) == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_packer_takes_tensors_and_numpy_alike(dtype):
    inst = random_edges(11)
    want = bucketize(inst, dtype=dtype, device="cpu")
    as_tensors = inst.to("cpu")
    assert isinstance(as_tensors.src, torch.Tensor)
    _assert_slabs(bucketize(as_tensors, dtype=dtype, device="cpu"),
                  host_bucketize(inst, dtype=dtype))
    got = bucketize(as_tensors, dtype=dtype, device="cpu")
    for a, b in zip(got.buckets, want.buckets):
        assert torch.equal(_bits(a.coeff), _bits(b.coeff))


def test_packer_single_slab_and_the_generator():
    inst = generate_matching_instance(MatchingInstanceSpec(
        num_sources=500, num_destinations=30, avg_degree=6.0, num_families=2, seed=5))
    deg = np.bincount(inst.src, minlength=500)
    width = _next_pow2(int(deg.max()))
    single = pack_single_slab(inst, shard_multiple=2, device="cpu")
    assert len(single.buckets) == 1 and single.buckets[0].length == width
    _assert_slabs(single, host_bucketize(inst, shard_multiple=2, min_length=width))
    _assert_slabs(bucketize(inst, device="cpu"), host_bucketize(inst))


def test_packer_refusals():
    inst = random_edges(3)
    with pytest.raises(ValueError, match="exceeds max bucket length"):
        bucketize(inst, max_length=8, device="cpu")
    empty = dataclasses.replace(inst, src=inst.src[:0], dst=inst.dst[:0],
                                values=inst.values[:0], coeff=inst.coeff[:, :0])
    with pytest.raises(ValueError, match="no edges"):
        bucketize(empty, device="cpu")


def test_packer_counts_its_slots_and_spans_its_work():
    inst = random_edges(5)
    prev = (telemetry.set_registry(telemetry.MetricsRegistry()),
            telemetry.set_tracer(telemetry.Tracer()))
    try:
        packed = bucketize(inst, shard_multiple=4, device="cpu")
        scaled, _ = normalize_rows(packed)
        reg = telemetry.get_registry()
        for b in packed.buckets:
            assert reg.counter_value("packed_slots_total", bucket=b.length) == b.rows * b.length
            assert b.rows % 4 == 0
        names = [e["name"] for e in telemetry.get_tracer().events()]
        assert names == ["pack", "normalize"]
        normalize_rows_traced(packed)  # the engines' form opens no span
        assert len(telemetry.get_tracer().events()) == 2
    finally:
        telemetry.set_registry(prev[0])
        telemetry.set_tracer(prev[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["mixed", "sparse"])
def test_unpack_primal_matches_the_loop(case, dtype):
    inst = random_edges(13, case=case)
    packed = bucketize(inst, dtype=dtype, shard_multiple=2, device="cpu")
    gen = torch.Generator().manual_seed(1)
    xs = [torch.rand(b.idx.shape, generator=gen).to(torch.bfloat16 if dtype == "bfloat16"
                                                     else torch.float32)
          for b in packed.buckets]
    info = packed.pack_info
    got = unpack_primal(packed, xs)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, host_unpack(info.degrees, info.edge_starts, xs))
    if dtype != "bfloat16":  # numpy slabs too
        np.testing.assert_array_equal(unpack_primal(packed, [x.numpy() for x in xs]), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["mixed", "flat"])
def test_normalize_rows_matches_the_host_form(case, dtype):
    packed = bucketize(random_edges(17, case=case), dtype=dtype, device="cpu")
    scaled, d = normalize_rows(packed)
    d_want, coeffs, rhs = host_normalize(packed)
    assert d.dtype == torch.float64 and d.device == packed.device
    # within 1e-12 relative, and on the CPU the same bits
    assert np.max(np.abs(d.numpy() - d_want) / d_want) <= 1e-12
    np.testing.assert_array_equal(d.numpy(), d_want)
    if case == "mixed":
        assert d_want[0] == 1.0  # the row with no coefficient
    for b, raw, (coeff, scale) in zip(scaled.buckets, packed.buckets, coeffs):
        assert torch.equal(_bits(b.coeff), _bits(coeff))
        if scale is None:
            assert b.coeff_scale is None
        else:
            assert torch.equal(b.coeff_scale, scale)
        for name in ("idx", "cost", "mask", "cost_scale"):
            assert getattr(b, name) is getattr(raw, name)
    assert torch.equal(scaled.rhs, rhs)
    assert scaled.pack_info is packed.pack_info
