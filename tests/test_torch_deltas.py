"""Port parity: delta ingestion (`instances.deltas`) and the single-tenant
service engine (`service.engine`) against the JAX package.

The same seeded sequence of deltas goes to both packages' ingestors: in-place
edits with an rhs replacement, a row move, delete-all-then-reinsert, a
source removed and a new one added, a rejected delta, a headroom-overflow
fallback, and edits after it; in fp32 and bf16 slabs.  After every step,
exactly:
  * the host slabs (bf16 as bit patterns) and the rhs are equal;
  * the `ScatterPlan`s are equal: runs, cell values, `nbytes`, generation;
  * the `DeltaReport`s are equal, field by field;
  * the telemetry counters are equal (both registries' snapshots; the
    port's `packed_slots_total` aside, a counter the reference lacks);
  * the device replay (`apply_scatter_plan` on CPU tensors) equals the host
    slabs bit for bit and leaves its input instance untouched.
`state_dict`/`from_state` round-trips bit for bit (and restores the
reference's state), `to_edge_list` and `unpack_primal` equal the
reference's, and the objective on the ingested slabs equals a fresh
`bucketize` of the mutated edge list (tests/test_deltas.py's bounds).
`compiled_solver` (fused and unfused, on the CPU) runs a cold solve, a
replay and a warm solve, then `compiled_solver_fixed_sigma`, and matches the
reference's `compiled_solver` cadence within 1e-5 rel-L2 in lam (the
Maximizer's bound, tests/test_torch_solve.py) with the reference's
power-iteration start vector.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro import telemetry as jtel
from repro.core import MaximizerConfig as JaxConfig
from repro.instances import DeltaIngestor as JaxIngestor
from repro.instances import InstanceDelta as JaxDelta
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import generate_matching_instance as jax_generate
from repro.service import apply_scatter_plan as jax_apply_scatter_plan
from repro.service import compiled_solver as jax_compiled_solver
from repro.service import compiled_solver_fixed_sigma as jax_compiled_solver_fixed_sigma
from repro.service import device_put_instance as jax_device_put_instance
from repro_torch import convert, telemetry
from repro_torch.core import MaximizerConfig, MatchingObjective
from repro_torch.core import objective as tobj
from repro_torch.instances import (
    DeltaIngestor,
    InstanceDelta,
    MatchingInstanceSpec,
    apply_delta_to_edge_list,
    bucketize,
    generate_matching_instance,
)
from repro_torch.service import (
    apply_scatter_plan,
    compile_cache_report,
    compiled_solver,
    compiled_solver_fixed_sigma,
    device_put_instance,
    instance_nbytes,
    to_solve_result,
)

SPEC = dict(num_sources=150, num_destinations=12, avg_degree=4.0, num_families=2, seed=5)


@pytest.fixture(autouse=True)
def fresh_telemetry():
    prev = (telemetry.set_registry(telemetry.MetricsRegistry()),
            jtel.set_registry(jtel.MetricsRegistry()))
    yield
    telemetry.set_registry(prev[0])
    jtel.set_registry(prev[1])


@pytest.fixture
def jax_start_vector(monkeypatch):
    """Make the port draw the reference's power-iteration start vector."""

    def start_vector(n, seed, device):
        u0 = jax.random.normal(jax.random.key(seed), (n,), jnp.float32)
        return torch.from_numpy(np.array(u0)).to(device)

    monkeypatch.setattr(tobj, "start_vector", start_vector)


def _bits(a) -> np.ndarray:
    """Bit patterns of a slab: a tensor (bf16 included) or a reference array
    (ml_dtypes bf16 included)."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _assert_bits(got, want, what=""):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


def _assert_instance(got, want):
    """A port instance equals a reference instance bit for bit."""
    assert len(got.buckets) == len(want.buckets)
    for t, (a, b) in enumerate(zip(got.buckets, want.buckets)):
        assert a.length == b.length
        for k in ("idx", "coeff", "cost", "mask"):
            _assert_bits(getattr(a, k), np.asarray(getattr(b, k)), f"bucket {t} {k}")
    _assert_bits(got.rhs, np.asarray(want.rhs), "rhs")


def _assert_same_instance(a, b):
    for x, y in zip(a.buckets, b.buckets):
        for k in ("idx", "coeff", "cost", "mask"):
            _assert_bits(getattr(x, k), getattr(y, k), k)
    _assert_bits(a.rhs, b.rhs, "rhs")


def _assert_plan(got, want):
    if want is None:
        assert got is None
        return
    ref = convert.scatter_plan_from_reference(want)
    assert got.generation == want.generation
    assert (got.nbytes, got.num_cells, got.num_runs) == (want.nbytes, want.num_cells, want.num_runs)
    assert len(got.ops) == len(ref.ops)
    for a, b in zip(got.ops, ref.ops):
        assert a.bucket == b.bucket
        for k in ("run_rows", "run_slots", "run_lengths", "idx", "cost", "mask", "coeff"):
            assert getattr(a, k).dtype == getattr(b, k).dtype, k
            _assert_bits(getattr(a, k), getattr(b, k), k)
        _assert_bits(a.rows, b.rows), _assert_bits(a.slots, b.slots)
    if want.rhs is None:
        assert got.rhs is None
    else:
        _assert_bits(got.rhs, ref.rhs, "plan rhs")


def _assert_report(got, want):
    for f in dataclasses.fields(want):
        if f.name != "plan":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    _assert_plan(got.plan, want.plan)


def _counters():
    """Both registries' snapshots; the port's own packing counter
    (`packed_slots_total`, which the reference does not keep) is left out
    of the port's."""
    got = telemetry.get_registry().snapshot()
    got["counters"] = {k: v for k, v in got["counters"].items()
                       if not k.startswith("packed_slots_total{")}
    return got, jtel.get_registry().snapshot()


def _random_delta(ref, rng, n_upd=15, n_del=6, n_ins=6, rhs=True):
    """tests/test_deltas.py's generator, on the reference's edge list."""
    m, J, I = ref.spec.num_families, ref.spec.num_destinations, ref.spec.num_sources
    perm = rng.permutation(ref.nnz)
    upd, dele = perm[:n_upd], perm[n_upd: n_upd + n_del]
    existing = set((ref.src * J + ref.dst).tolist())
    ins_s, ins_d = [], []
    while len(ins_s) < n_ins:
        s, d = int(rng.integers(I)), int(rng.integers(J))
        if s * J + d not in existing:
            existing.add(s * J + d)
            ins_s.append(s)
            ins_d.append(d)
    return JaxDelta(
        insert_src=ins_s, insert_dst=ins_d,
        insert_values=rng.uniform(0.1, 5.0, n_ins),
        insert_coeff=rng.uniform(0.1, 2.0, (m, n_ins)),
        delete_src=ref.src[dele], delete_dst=ref.dst[dele],
        update_src=ref.src[upd], update_dst=ref.dst[upd],
        update_values=rng.uniform(0.1, 5.0, n_upd),
        update_coeff=rng.uniform(0.1, 2.0, (m, n_upd)),
        rhs=np.asarray(ref.rhs) * rng.uniform(0.9, 1.1, ref.rhs.size) if rhs else None,
    )


def _scenario(ing_j: JaxIngestor, rng):
    """The delta sequence, each built from the reference's current state;
    yields (name, delta, expected exception or None)."""
    m, J = SPEC["num_families"], SPEC["num_destinations"]
    cur = ing_j.to_edge_list()
    yield "mixed", _random_delta(cur, rng), None
    # grow a low-degree source past its bucket width: a row move
    cur = ing_j.to_edge_list()
    deg = ing_j.deg
    widest = max(b.length for b in ing_j.instance().buckets)
    cands = np.flatnonzero((deg >= 2) & (deg <= widest // 2))
    s = int(cands[np.argmax(deg[cands])])
    have = set(cur.dst[cur.src == s].tolist())
    grow = int(2 ** np.ceil(np.log2(deg[s])) + 1 - deg[s])
    new_d = [d for d in range(J) if d not in have][:grow]
    yield "row_move", JaxDelta(
        insert_src=[s] * len(new_d), insert_dst=new_d,
        insert_values=rng.uniform(0.1, 5.0, len(new_d)),
        insert_coeff=rng.uniform(0.1, 2.0, (m, len(new_d))),
    ), None
    # delete every edge of a source and reinsert one in the same delta
    cur = ing_j.to_edge_list()
    s = int(cur.src[0])
    dsts = cur.dst[cur.src == s]
    yield "delete_all_reinsert", JaxDelta(
        delete_src=[s] * dsts.size, delete_dst=dsts,
        insert_src=[s], insert_dst=[int(dsts[0])],
        insert_values=[2.5], insert_coeff=[[1.5]] * m,
    ), None
    # a source removed entirely, a brand-new one added
    cur = ing_j.to_edge_list()
    s = int(cur.src[-1])
    dsts = cur.dst[cur.src == s]
    absent = np.setdiff1d(np.arange(SPEC["num_sources"]), np.unique(cur.src))
    assert absent.size, "the instance has no empty source"
    yield "new_source", JaxDelta(
        delete_src=[s] * dsts.size, delete_dst=dsts,
        insert_src=[int(absent[0])], insert_dst=[int(dsts[0])],
        insert_values=[1.0], insert_coeff=[[1.0]] * m,
    ), None
    # rejected: the first delete is valid, the second targets a missing edge
    cur = ing_j.to_edge_list()
    s1, d1 = int(cur.src[0]), int(cur.dst[0])
    missing = next(x for x in range(J) if x not in set(cur.dst[cur.src == s1].tolist()))
    yield "rejected", JaxDelta(delete_src=[s1, s1], delete_dst=[d1, missing]), KeyError
    yield "out_of_range", JaxDelta(delete_src=[SPEC["num_sources"] + 1], delete_dst=[0]), ValueError
    # a source with an edge to every destination: beyond the widest bucket
    have = set(cur.dst[cur.src == s1].tolist())
    new_d = [d for d in range(J) if d not in have]
    yield "overflow", JaxDelta(
        insert_src=[s1] * len(new_d), insert_dst=new_d,
        insert_values=np.ones(len(new_d)), insert_coeff=np.ones((m, len(new_d))),
        update_src=cur.src[5:9], update_dst=cur.dst[5:9],
        update_values=rng.uniform(0.1, 5.0, 4),
    ), None
    yield "after_fallback", _random_delta(ing_j.to_edge_list(), rng), None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ingestors_agree_step_by_step(dtype):
    base = generate_matching_instance(MatchingInstanceSpec(**SPEC))
    base_j = jax_generate(JaxSpec(**SPEC))
    ing = DeltaIngestor(base, row_headroom=4, dtype=dtype)
    ing_j = JaxIngestor(base_j, row_headroom=4, dtype=dtype)
    for obj in (ing, ing_j):
        obj.telemetry_tenant = "t0"
    _assert_instance(ing.instance(), ing_j.instance())
    dev = device_put_instance(ing.instance(), "cpu")
    ref = base
    lam = torch.from_numpy(np.random.default_rng(1).random(ing.instance().dual_dim)
                           .astype(np.float32))
    seen, moved = set(), 0
    for name, delta_j, error in _scenario(ing_j, np.random.default_rng(0)):
        delta = convert.delta_from_reference(delta_j)
        if error is not None:
            with pytest.raises(error):
                ing.apply(delta)
            with pytest.raises(error):
                ing_j.apply(delta_j)
            assert ing.generation == ing_j.generation
        else:
            rep, rep_j = ing.apply(delta), ing_j.apply(delta_j)
            _assert_report(rep, rep_j)
            seen.add((name, rep.in_place))
            moved += rep.moved_rows if name == "row_move" else 0
            ref = apply_delta_to_edge_list(ref, delta)
            if rep.plan is None:
                dev = device_put_instance(ing.instance(), "cpu")
            else:
                before = device_put_instance(dev, "cpu")
                new = apply_scatter_plan(dev, rep.plan)
                _assert_same_instance(dev, before)  # the input is untouched
                dev = new
        _assert_instance(ing.instance(), ing_j.instance())
        _assert_same_instance(dev, ing.instance())
        got, want = _counters()
        assert got["counters"] == want["counters"], name
        assert ing.drain_cost_drift() == ing_j.drain_cost_drift()
        assert ing.headroom() == ing_j.headroom()
        assert ing._free_rows == ing_j._free_rows
        # the edge lists, and the objective against a fresh pack of them
        cur, cur_j = ing.to_edge_list(), ing_j.to_edge_list()
        for k in ("src", "dst", "values", "coeff", "rhs"):
            np.testing.assert_array_equal(getattr(cur, k), getattr(cur_j, k), err_msg=k)
        np.testing.assert_array_equal(cur.src, ref.src)
        np.testing.assert_allclose(cur.values, ref.values, rtol=1e-2 if dtype == "bfloat16" else 1e-6)
        if dtype == "float32":
            ev_a = MatchingObjective(dev).calculate(lam, 0.1)
            ev_b = MatchingObjective(bucketize(ref, device="cpu")).calculate(lam, 0.1)
            np.testing.assert_allclose(float(ev_a.g), float(ev_b.g), rtol=1e-5)
            np.testing.assert_allclose(ev_a.grad.numpy(), ev_b.grad.numpy(), atol=1e-4)
    assert seen == {("mixed", True), ("row_move", True), ("delete_all_reinsert", True),
                    ("new_source", True), ("overflow", False), ("after_fallback", True)}
    assert moved >= 1
    # unpack_primal keys survive the moves and the fallback
    xs = [torch.rand(b.idx.shape, generator=torch.Generator().manual_seed(t))
          for t, b in enumerate(ing.instance().buckets)]
    keys, x = ing.unpack_primal(xs)
    keys_j, x_j = ing_j.unpack_primal([x.numpy() for x in xs])
    np.testing.assert_array_equal(keys, keys_j)
    np.testing.assert_array_equal(x, x_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_roundtrip_bit_for_bit(dtype):
    """from_state(state_dict()) reproduces slabs, maps, headroom and plans,
    and restores the reference's state_dict to the reference's slabs."""
    base = generate_matching_instance(MatchingInstanceSpec(**SPEC))
    base_j = jax_generate(JaxSpec(**SPEC))
    ing = DeltaIngestor(base, row_headroom=4, dtype=dtype)
    ing_j = JaxIngestor(base_j, row_headroom=4, dtype=dtype)
    rng = np.random.default_rng(41)
    d = _random_delta(base_j, rng)
    ing.apply(convert.delta_from_reference(d))
    ing_j.apply(d)
    back = DeltaIngestor.from_state(*ing.state_dict())
    from_ref = DeltaIngestor.from_state(*ing_j.state_dict())
    for other in (back, from_ref):
        assert other.generation == ing.generation
        assert other.headroom() == ing.headroom()
        assert other._free_rows == ing._free_rows
        _assert_same_instance(other.instance(), ing.instance())
    arrays, meta = ing.state_dict()
    arrays_j, meta_j = ing_j.state_dict()
    assert meta == meta_j and set(arrays) == set(arrays_j)
    for k in arrays:
        _assert_bits(arrays[k], arrays_j[k], k)
    # identical future behaviour: the same delta gives identical plans
    nxt = _random_delta(ing_j.to_edge_list(), rng, n_upd=5, n_del=2, n_ins=2)
    reps = [o.apply(convert.delta_from_reference(nxt)) for o in (ing, back, from_ref)]
    rep_j = ing_j.apply(nxt)
    for rep in reps:
        _assert_report(rep, rep_j)


# Enough edges that a 2% delta holds hundreds of updates in several buckets.
WIDE = dict(num_sources=3000, num_destinations=64, avg_degree=6.0, num_families=2, seed=7)


def _pair(dtype, spec=WIDE):
    """A port ingestor and the reference's, on the same generated instance."""
    ing = DeltaIngestor(generate_matching_instance(MatchingInstanceSpec(**spec)),
                        row_headroom=4, dtype=dtype)
    ing_j = JaxIngestor(jax_generate(JaxSpec(**spec)), row_headroom=4, dtype=dtype)
    return ing, ing_j


def _row(ing, s):
    """Destinations of source s in slot order."""
    t, r = int(ing.bucket_of[s]), int(ing.row_of[s])
    return ing._slabs[t].idx[r, : int(ing.deg[s])].astype(np.int64)


def _update_heavy_delta(ing, rng, fields):
    """Updates of ~2% of the edges, in random order, with three that the
    earlier steps of the same delta make hard to find: an update of an edge
    it inserts, one of the edge a delete swaps from the last slot into the
    hole, and one of a source whose row moves to a wider bucket."""
    cur = ing.to_edge_list()
    m, J = WIDE["num_families"], WIDE["num_destinations"]
    deg = ing.deg
    width = np.asarray(ing._lengths)[ing.bucket_of]  # of each source's row
    # a delete of slot 0 swaps the last slot into the hole
    s_swap = int(np.flatnonzero(deg >= 3)[0])
    row = _row(ing, s_swap)
    # a source filled to its bucket's width grows by one: its row moves
    full = np.flatnonzero((deg >= 2) & (deg == width) & (width < ing._lengths[-1]))
    s_move = int(next(s for s in full if s != s_swap))
    # a source with room in its row gains an edge in place
    roomy = np.flatnonzero((deg >= 1) & (deg < width))
    s_ins = int(next(s for s in roomy if s not in (s_swap, s_move)))
    ins = [(s, next(d for d in range(J) if d not in set(_row(ing, s).tolist())))
           for s in (s_move, s_ins)]
    dels = [(s_swap, int(row[0]))]
    forced = [(s_swap, int(row[-1])), (s_move, int(_row(ing, s_move)[0]))] + ins
    taken = {s * J + d for s, d in forced + dels}
    key = cur.src * J + cur.dst
    pool = rng.permutation(np.flatnonzero(~np.isin(key, list(taken))))
    n = max(int(0.02 * key.size), 1) - len(forced)
    upd = [(int(cur.src[e]), int(cur.dst[e])) for e in pool[:n]] + forced
    upd = [upd[i] for i in rng.permutation(len(upd))]
    k = len(upd)
    return JaxDelta(
        insert_src=[s for s, _ in ins], insert_dst=[d for _, d in ins],
        insert_values=rng.uniform(0.1, 5.0, len(ins)),
        insert_coeff=rng.uniform(0.1, 2.0, (m, len(ins))),
        delete_src=[s for s, _ in dels], delete_dst=[d for _, d in dels],
        update_src=[s for s, _ in upd], update_dst=[d for _, d in upd],
        update_values=rng.uniform(0.1, 5.0, k) if "values" in fields else None,
        update_coeff=rng.uniform(0.1, 2.0, (m, k)) if "coeff" in fields else None,
    )


@pytest.mark.parametrize("fields", ["values", "coeff", "values+coeff"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_heavy_delta_matches_reference(dtype, fields):
    """A delta of ~2% updates (the array path) equals the reference's
    per-edit path exactly: slabs, plan, report, counters and drift; the
    replay of its plan equals the host slabs."""
    ing, ing_j = _pair(dtype)
    delta_j = _update_heavy_delta(ing, np.random.default_rng(3), fields)
    assert delta_j.update_src.size >= 300
    dev = device_put_instance(ing.instance(), "cpu")
    rep, rep_j = ing.apply(convert.delta_from_reference(delta_j)), ing_j.apply(delta_j)
    assert rep.in_place and rep.moved_rows == 1
    _assert_report(rep, rep_j)
    _assert_instance(ing.instance(), ing_j.instance())
    _assert_same_instance(apply_scatter_plan(dev, rep.plan), ing.instance())
    got, want = _counters()
    assert got["counters"] == want["counters"]
    assert ing.drain_cost_drift() == ing_j.drain_cost_drift()
    assert ing._free_rows == ing_j._free_rows


def _rejected_updates(ing, case):
    """Updates with two offending edits, the first of kind `case`.  The
    absent edge points at destination 0 from a row with padding, whose
    slots past the degree hold index 0 too."""
    J = WIDE["num_destinations"]
    cur = ing.to_edge_list()
    src, dst = cur.src.tolist(), cur.dst.tolist()
    s0 = src[0]
    padded = np.flatnonzero((ing.deg >= 1) & (ing.deg < np.asarray(ing._lengths)[ing.bucket_of]))
    absent = (int(next(s for s in padded if 0 not in _row(ing, s))), 0)
    ok = list(zip(src[10:20], dst[10:20]))
    deleted = (src[5], dst[5])
    if case == "duplicate":
        upd = ok[:4] + [ok[1]] + [absent]
    elif case == "deleted":
        upd = ok[:4] + [deleted] + [ok[1]]
    elif case == "absent":
        upd = ok[:4] + [absent] + [deleted]
    else:  # dst_range
        upd = ok[:4] + [(s0, J)] + [absent]
    return JaxDelta(
        delete_src=[deleted[0]], delete_dst=[deleted[1]],
        update_src=[s for s, _ in upd], update_dst=[d for _, d in upd],
        update_values=np.linspace(0.5, 2.0, len(upd)),
    )


@pytest.mark.parametrize("case, error", [("duplicate", KeyError), ("deleted", KeyError),
                                         ("absent", KeyError), ("dst_range", ValueError)])
def test_rejected_updates_leave_state_unchanged(case, error):
    """A bad update raises the reference's exception, naming the same edit,
    before any mutation: slabs, generation, drift and free rows stay."""
    ing, ing_j = _pair("float32")
    warm = _random_delta(ing_j.to_edge_list(), np.random.default_rng(4))
    ing.apply(convert.delta_from_reference(warm)), ing_j.apply(warm)
    before = device_put_instance(ing.instance(), "cpu")
    gen, pending, free = ing.generation, ing._pending_dc_sq, [list(f) for f in ing._free_rows]
    delta_j = _rejected_updates(ing, case)
    with pytest.raises(error) as got:
        ing.apply(convert.delta_from_reference(delta_j))
    with pytest.raises(error) as want:
        ing_j.apply(delta_j)
    assert str(got.value) == str(want.value)
    _assert_same_instance(ing.instance(), before)
    _assert_instance(ing.instance(), ing_j.instance())
    assert (ing.generation, ing._pending_dc_sq, ing._free_rows) == (gen, pending, free)
    assert ing.drain_cost_drift() == ing_j.drain_cost_drift()
    got_c, want_c = _counters()
    assert got_c["counters"] == want_c["counters"]


def test_refusals():
    base = generate_matching_instance(MatchingInstanceSpec(**SPEC))
    with pytest.raises(ValueError, match="int8"):
        DeltaIngestor(base, dtype="int8")
    with pytest.raises(ValueError, match="size mismatch"):
        InstanceDelta(insert_src=[1, 2], insert_dst=[1])


def test_replay_refuses_a_cast():
    """The plan's cells carry the slab dtype: replaying an fp32 plan on
    bf16 slabs raises rather than casting."""
    base = generate_matching_instance(MatchingInstanceSpec(**SPEC))
    ing = DeltaIngestor(base, row_headroom=4)
    narrow = DeltaIngestor(base, row_headroom=4, dtype="bfloat16")
    rep = ing.apply(convert.delta_from_reference(
        _random_delta(jax_generate(JaxSpec(**SPEC)), np.random.default_rng(2))))
    with pytest.raises(ValueError, match="bfloat16 slab"):
        apply_scatter_plan(device_put_instance(narrow.instance(), "cpu"), rep.plan)


def test_device_put_owns_its_memory():
    base = generate_matching_instance(MatchingInstanceSpec(**SPEC))
    ing = DeltaIngestor(base, row_headroom=4)
    dev = device_put_instance(ing.instance(), "cpu")
    before = float(dev.buckets[0].cost.sum())
    ing._slabs[0].cost[...] = 7.0  # a host edit must not reach the copy
    assert float(dev.buckets[0].cost.sum()) == before
    assert instance_nbytes(dev) == sum(
        t.numel() * t.element_size()
        for b in dev.buckets for t in (b.idx, b.coeff, b.cost, b.mask)) + 4 * dev.dual_dim
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            device_put_instance(ing.instance())


@pytest.mark.parametrize("fused", [False, True])
def test_cadence_matches_reference(jax_start_vector, fused):
    """Cold solve, replay, warm solve (power iteration), replay of a
    cost-only delta, warm solve with the previous sigma^2: lam within 1e-5
    rel-L2 of the reference's cadence at every solve."""
    base = generate_matching_instance(MatchingInstanceSpec(**SPEC))
    base_j = jax_generate(JaxSpec(**SPEC))
    ing = DeltaIngestor(base, row_headroom=8)
    ing_j = JaxIngestor(base_j, row_headroom=8)
    cold = dict(iters_per_stage=25)
    warm = dict(gammas=(0.1, 0.01), iters_per_stage=25)
    dev = device_put_instance(ing.instance(), "cpu")
    dev_j = jax_device_put_instance(ing_j.instance())
    raw = compiled_solver(MaximizerConfig(**cold), normalize=True, fused_oracle=fused)(
        dev, torch.zeros(dev.dual_dim))
    raw_j = jax_compiled_solver(JaxConfig(**cold), normalize=True, fused_oracle=fused)(
        dev_j, jnp.zeros(dev.dual_dim, jnp.float32))
    rng = np.random.default_rng(7)

    def rel(a, b):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(raw.lam, raw_j.lam) <= 1e-5
    for step, (n_ins, n_del) in enumerate(((3, 3), (0, 0))):
        d = _random_delta(ing_j.to_edge_list(), rng, n_upd=20, n_del=n_del, n_ins=n_ins)
        if step:  # the cost-only delta keeps A: drop its coefficient updates
            d = dataclasses.replace(d, update_coeff=None)
        rep, rep_j = ing.apply(convert.delta_from_reference(d)), ing_j.apply(d)
        dev, dev_j = apply_scatter_plan(dev, rep.plan), jax_apply_scatter_plan(dev_j, rep_j.plan)
        _assert_instance(dev, dev_j)
        if step == 0:
            raw = compiled_solver(MaximizerConfig(**warm), normalize=True, fused_oracle=fused)(
                dev, raw.lam)
            raw_j = jax_compiled_solver(JaxConfig(**warm), normalize=True, fused_oracle=fused)(
                dev_j, raw_j.lam)
        else:
            raw = compiled_solver_fixed_sigma(
                MaximizerConfig(**warm), normalize=True, fused_oracle=fused)(
                dev, raw.lam, raw.sigma_sq)
            raw_j = jax_compiled_solver_fixed_sigma(
                JaxConfig(**warm), normalize=True, fused_oracle=fused)(
                dev_j, raw_j.lam, raw_j.sigma_sq)
        assert rel(raw.lam, raw_j.lam) <= 1e-5, step
        res = to_solve_result(raw)
        assert res.iters_used == (25, 25) and res.restarts == 0
        np.testing.assert_allclose(res.steps, np.asarray(raw_j.etas), rtol=1e-5)
    assert float(raw.sigma_sq) == float(res.sigma_sq)
    report = compile_cache_report()
    assert any(k.startswith("single_sigma:") and f"fused={fused}" in k for k in report)
