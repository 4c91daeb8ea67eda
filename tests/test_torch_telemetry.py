"""Port parity: the telemetry package against the JAX package's.

The registry, spans, Chrome trace, JSONL schema and Prometheus cases of
tests/test_telemetry.py run on the port.  The same sequence of registry
operations gives byte-for-byte the same `prometheus_text` and the same
`snapshot()` in both packages (the registry is pure Python in both).
`ConvergenceTrace.from_result(...).summary()` and `StallDetector` on a
port solve equal the reference's on the same seeded solve: the integer and
boolean fields exactly, the final g within rtol 1e-5 (the reference's own
trajectory bound, tests/test_dual_oracle.py); the port draws the
reference's power-iteration start vector.  The final grad norm and
violation are differences of A x and b that nearly cancel at a converged
iterate, so they are held at atol 1e-5 * ||b||: on the 300-iteration
early-stopped solve below the two packages' lam end 3.8e-5 rel-L2 apart
(ROADMAP Queue 3: long early-stopped solves drift past 1e-5) and the grad
norms 0.0081 and 0.0075 (||b|| = 102).
"""
import json
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro import telemetry as jtel
from repro.core import Maximizer as JaxMaximizer
from repro.core import MaximizerConfig as JaxConfig
from repro.core.objective import MatchingObjective as JaxObjective
from repro.core.pdhg import PDHGConfig as JaxPDHGConfig
from repro.core.pdhg import from_edge_list as jax_from_edge_list
from repro.core.pdhg import solve_pdhg as jax_solve_pdhg
from repro.instances import MatchingInstanceSpec as JaxSpec
from repro.instances import bucketize as jax_bucketize
from repro.instances import generate_matching_instance as jax_generate
from repro_torch import convert
from repro_torch import telemetry
from repro_torch.core import Maximizer, MaximizerConfig, MatchingObjective
from repro_torch.core import objective as tobj
from repro_torch.core import pdhg as tpdhg
from repro_torch.formulation import scenario_formulation
from repro_torch.instances import (
    DeltaIngestor,
    InstanceDelta,
    MatchingInstanceSpec,
    generate_matching_instance,
)
from repro_torch.engines.agd import agd_raw_solve, agd_raw_solve_batched
from repro_torch.service import Scheduler, ServiceConfig, compiled_solver, stack_instances
from repro_torch.telemetry import (
    SCHEMA,
    ConvergenceTrace,
    JsonlSink,
    MetricsRegistry,
    StallDetector,
    Tracer,
    prometheus_text,
    validate_jsonl,
)
from repro_torch.telemetry import tracing
from repro_torch.telemetry.tracing import NullTracer

SPEC = dict(num_sources=120, num_destinations=10, avg_degree=4.0, seed=21)
BASE = generate_matching_instance(MatchingInstanceSpec(**SPEC))
BASE_J = jax_generate(JaxSpec(**SPEC))
PACKED_J = jax_bucketize(BASE_J)
PACKED = convert.instance_from_reference(PACKED_J, device="cpu")


@pytest.fixture(autouse=True)
def fresh_telemetry():
    """Isolate every test behind its own registry + tracer (both packages)."""
    prev = (telemetry.set_registry(MetricsRegistry()), telemetry.set_tracer(Tracer()),
            jtel.set_registry(jtel.MetricsRegistry()), jtel.set_tracer(jtel.Tracer()))
    yield
    telemetry.set_registry(prev[0])
    telemetry.set_tracer(prev[1])
    jtel.set_registry(prev[2])
    jtel.set_tracer(prev[3])


def _jax_start_vector(n, seed, device):
    u0 = jax.random.normal(jax.random.key(seed), (n,), jnp.float32)
    return torch.from_numpy(np.array(u0)).to(device)


@pytest.fixture
def jax_start_vector(monkeypatch):
    """Make the port draw the reference's power-iteration start vector."""
    monkeypatch.setattr(tobj, "start_vector", _jax_start_vector)
    monkeypatch.setattr(tpdhg, "start_vector", _jax_start_vector)


def _perturb_delta(edge_list, rng, frac=0.1):
    n = max(1, int(frac * edge_list.nnz))
    idx = rng.permutation(edge_list.nnz)[:n]
    return InstanceDelta(
        update_src=edge_list.src[idx],
        update_dst=edge_list.dst[idx],
        update_values=edge_list.values[idx] * rng.uniform(0.9, 1.1, n),
    )


# -- the same operations, both registries --------------------------------------


def _drive(reg, rng):
    """A seeded sequence of registry operations with labels, odd names and
    values across the histogram's decades."""
    for i in range(40):
        op = rng.integers(3)
        tenant = f"t{rng.integers(3)}"
        v = float(rng.choice([1e-5, 3e-3, 0.7, 4.0, 2e4, 7e9, 3e10])) * rng.uniform(0.5, 1.5)
        if op == 0:
            reg.inc("solves_total", v, tenant=tenant, mode=["cold", "warm"][i % 2])
        elif op == 1:
            reg.set_gauge("queue-depth", v, tenant=tenant)
        else:
            reg.observe("latency_seconds", v, **({"tenant": tenant} if i % 3 else {}))
    reg.inc("weird name/with:chars", 2, label='quote"and\\slash\nnewline')
    reg.inc("int_total", 3)


def test_prometheus_text_and_snapshot_equal_reference():
    reg, jreg = MetricsRegistry(), jtel.MetricsRegistry()
    _drive(reg, np.random.default_rng(11))
    _drive(jreg, np.random.default_rng(11))
    assert prometheus_text(reg) == jtel.prometheus_text(jreg)
    assert json.dumps(reg.snapshot(), sort_keys=True) == json.dumps(
        jreg.snapshot(), sort_keys=True)
    assert reg.state_dict() == jreg.state_dict()
    # the counters restore across packages both ways
    back, jback = MetricsRegistry(), jtel.MetricsRegistry()
    back.load_state(jreg.state_dict())
    jback.load_state(reg.state_dict())
    assert back.state_dict() == jback.state_dict() == reg.state_dict()


def test_schema_and_all_equal_reference():
    assert SCHEMA == jtel.SCHEMA
    assert telemetry.__all__ == jtel.__all__
    assert telemetry.DEFAULT_BUCKETS == jtel.DEFAULT_BUCKETS


# -- JSONL ---------------------------------------------------------------------


def test_jsonl_sink_roundtrip_and_validation(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with JsonlSink(path) as sink:
        sink.emit("ingest", {
            "tenant": "t0", "in_place": True,
            "n_insert": 1, "n_delete": 0, "n_update": np.int64(3),
        })
        sink.emit_counters()
    n, errors = validate_jsonl(path)
    assert (n, errors) == (2, [])
    records = [json.loads(l) for l in open(path)]
    assert [r["kind"] for r in records] == ["ingest", "counters"]
    assert records[0]["payload"]["n_update"] == 3  # numpy scalar serialized
    with JsonlSink(path) as sink:  # append mode: prior records survive
        sink.emit("ingest", {
            "tenant": "t1", "in_place": False,
            "n_insert": 0, "n_delete": 0, "n_update": 0,
        })
    assert validate_jsonl(path)[0] == 3
    # the reference's validator reads the port's file the same way
    assert jtel.validate_jsonl(path) == validate_jsonl(path)

    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"ts": 1.0, "kind": "ingest", "payload": {"tenant": "x"}}\n')
    n, errors = validate_jsonl(str(bad))
    assert n == 1 and len(errors) == 4  # four missing required keys

    with pytest.raises(ValueError):
        JsonlSink(str(tmp_path / "x.jsonl")).emit("nope", {})


def test_jsonable_takes_tensors():
    payload = {"a": torch.tensor(2.5), "b": torch.arange(3, dtype=torch.int32),
               "c": torch.tensor([1.0, float("inf")]), "d": (np.float32(0.5),)}
    out = telemetry.jsonable(payload)
    assert out == {"a": 2.5, "b": [0, 1, 2], "c": [1.0, "inf"], "d": [0.5]}
    same = jtel.jsonable({k: (np.asarray(v) if isinstance(v, torch.Tensor) else v)
                          for k, v in payload.items()})
    assert out == same


# -- registry ------------------------------------------------------------------


def test_registry_labels_and_snapshot():
    reg = telemetry.get_registry()
    reg.inc("solves_total", 2, tenant="a", mode="cold")
    reg.inc("solves_total", 3, tenant="b", mode="warm")
    reg.set_gauge("queue_depth", 7)
    reg.observe("batch_size", 4)
    reg.observe("batch_size", 4)
    assert reg.counter_value("solves_total", tenant="a", mode="cold") == 2
    assert reg.counter_total("solves_total") == 5
    snap = reg.snapshot()
    assert snap["counters"]["solves_total{mode=cold,tenant=a}"] == 2
    assert snap["gauges"]["queue_depth"] == 7
    h = snap["histograms"]["batch_size"]
    assert h["count"] == 2 and h["sum"] == 8 and h["min"] == h["max"] == 4


def test_registry_thread_safety_under_hammer():
    """N writer threads + a concurrent snapshot reader: totals must be exact
    and snapshots must never crash mid-mutation."""
    reg = telemetry.get_registry()
    threads, iters = 8, 500
    stop = threading.Event()
    snaps = []

    def writer(t):
        for i in range(iters):
            reg.inc("hammer_total", 1, thread=t % 2)
            reg.observe("hammer_obs", i)
            reg.set_gauge("hammer_gauge", i, thread=t)

    def reader():
        while not stop.is_set():
            snaps.append(reg.snapshot())

    r = threading.Thread(target=reader)
    r.start()
    ws = [threading.Thread(target=writer, args=(t,)) for t in range(threads)]
    for w in ws:
        w.start()
    for w in ws:
        w.join()
    stop.set()
    r.join()
    assert reg.counter_total("hammer_total") == threads * iters
    assert reg.snapshot()["histograms"]["hammer_obs"]["count"] == threads * iters
    assert snaps


def test_registry_counter_state_roundtrip():
    reg = MetricsRegistry()
    reg.inc("a_total", 5, tenant="x")
    reg.inc("b_total", 2.5)
    reg.set_gauge("g", 1)  # gauges intentionally NOT checkpointed
    state = json.loads(json.dumps(reg.state_dict()))  # must be JSON-able
    fresh = MetricsRegistry()
    fresh.load_state(state)
    assert fresh.counter_value("a_total", tenant="x") == 5
    assert fresh.counter_value("b_total") == 2.5
    assert fresh.gauge_value("g") is None


# -- spans / chrome trace ------------------------------------------------------


def test_span_nesting_and_chrome_trace(tmp_path):
    tr = telemetry.get_tracer()
    with telemetry.span("cadence", index=0):
        with telemetry.span("solve", tenant="t0"):
            pass
        with telemetry.span("solve", tenant="t1"):
            pass
    events = tr.events()
    assert [e["name"] for e in events] == ["solve", "solve", "cadence"]
    cad = events[2]
    for child in events[:2]:
        assert cad["ts"] <= child["ts"]
        assert child["ts"] + child["dur"] <= cad["ts"] + cad["dur"] + 1e-6
    path = str(tmp_path / "t.json")
    tr.export_chrome_trace(path)
    doc = json.loads(open(path).read())
    assert {e["name"] for e in doc["traceEvents"]} == {"cadence", "solve"}
    for e in doc["traceEvents"]:  # Perfetto-required complete-event fields
        assert e["ph"] == "X"
        assert {"name", "ts", "dur", "pid", "tid", "args"} <= set(e)
    assert doc["traceEvents"][0]["args"] == {"tenant": "t0"}


def test_span_args_take_tensors():
    with telemetry.span("s", g=torch.tensor(1.5), n=torch.tensor(3), label="x"):
        pass
    (ev,) = telemetry.get_tracer().events()
    assert ev["args"] == {"g": 1.5, "n": 3.0, "label": "x"}
    json.dumps(ev)


def test_profiler_annotations_land_in_torch_profiler():
    """`profiler_annotations=True` (the reference's `jax_annotations`) puts
    the span names into a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer(profiler_annotations=True)
    assert not Tracer().profiler_annotations
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("cadence_x"):
            with tr.span("solve_y"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"cadence_x", "solve_y"} <= names
    assert [e["name"] for e in tr.events()] == ["solve_y", "cadence_x"]


def test_span_buffer_bound():
    tr = telemetry.set_tracer(Tracer(max_events=3))
    try:
        for i in range(5):
            with telemetry.span("s", i=i):
                pass
        got = telemetry.get_tracer()
        assert len(got.events()) == 3
        assert got.dropped == 2
    finally:
        telemetry.set_tracer(tr)


def test_maximizer_and_formulation_spans():
    """The Maximizer's power_iteration and stage spans and the formulation
    compile's span and counters, as the reference emits them."""
    cfg = MaximizerConfig(gammas=(1.0, 0.1), iters_per_stage=5)
    Maximizer(MatchingObjective(PACKED), cfg).solve()
    comp = scenario_formulation("capacity-cap").compile(PACKED)
    events = telemetry.get_tracer().events()
    names = [e["name"] for e in events]
    assert names == ["power_iteration", "stage", "stage", "formulation_compile"]
    assert [e["args"] for e in events[1:3]] == [
        {"stage": 0, "gamma": 1.0}, {"stage": 1, "gamma": 0.1}]
    assert events[3]["args"] == {"formulation": comp.spec.name, "primitives": 1}
    reg = telemetry.get_registry()
    assert reg.counter_value("formulation_compiles_total", formulation=comp.spec.name) == 1
    assert reg.counter_value("formulation_primitives_total", formulation=comp.spec.name) == 1
    snap = reg.snapshot()["histograms"]
    assert snap[f"formulation_compile_seconds{{formulation={comp.spec.name}}}"]["count"] == 1


# -- the port's spans: off by default, causality, the device clock --------------


SPANS_CFG = ServiceConfig(cold=MaximizerConfig(gammas=(1.0, 0.1), iters_per_stage=10),
                          warm_gammas=(0.1, 0.01), row_headroom=4)


def _mixed_delta(edge_list, rng, n_update=6):
    """Two deletes, three inserts of new edges, `n_update` updates of other
    edges and new budgets: a delta with every kind of edit."""
    I, J, m = (edge_list.spec.num_sources, edge_list.spec.num_destinations,
               edge_list.spec.num_families)
    keys = set((edge_list.src * J + edge_list.dst).tolist())
    order = rng.permutation(edge_list.nnz)
    dele, upd = order[:2], order[2:2 + n_update]
    new = []
    while len(new) < 3:
        k = int(rng.integers(I)) * J + int(rng.integers(J))
        if k not in keys and k not in new:
            new.append(k)
    new = np.array(new)
    return InstanceDelta(
        delete_src=edge_list.src[dele], delete_dst=edge_list.dst[dele],
        insert_src=new // J, insert_dst=new % J,
        insert_values=rng.uniform(0.5, 1.0, 3), insert_coeff=rng.uniform(0.5, 1.0, (m, 3)),
        update_src=edge_list.src[upd], update_dst=edge_list.dst[upd],
        update_values=edge_list.values[upd] * 1.05,
        rhs=np.full(m * J, 2.0),
    )


def _scheduler(tenants=1):
    sched = Scheduler(SPANS_CFG, device="cpu")
    for t in range(tenants):
        sched.add_tenant(f"t{t}", BASE)
    sched.run_cadence({})  # the cold cadence
    return sched


def test_default_tracer_records_nothing(monkeypatch):
    """A fresh process's tracer is the `NullTracer`, and under it a
    Maximizer solve and a scheduler cadence make no `Span`, read no clock
    for a span and record no event; its `span()` is one shared object."""
    import subprocess
    import sys

    code = ("from repro_torch import telemetry; "
            "print(type(telemetry.get_tracer()).__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "NullTracer", out.stderr[-2000:]

    sched = _scheduler()
    null = NullTracer()
    telemetry.set_tracer(null)

    class NoSpan:
        def __init__(self, *a, **k):
            raise AssertionError("a Span was made with tracing off")

    monkeypatch.setattr(tracing, "Span", NoSpan)
    Maximizer(MatchingObjective(PACKED), MaximizerConfig(gammas=(1.0,), iters_per_stage=5)).solve()
    sched.run_cadence({"t0": _mixed_delta(BASE, np.random.default_rng(1))})
    assert null.events() == [] and null.to_chrome_trace()["traceEvents"] == []
    assert telemetry.span("a", device=torch.device("cpu"), x=1) is telemetry.span("b")
    with telemetry.span("a") as sp:
        sp.set(y=2)
        assert sp.id is None and telemetry.get_tracer().current() is None


def _chain(events: list[dict]) -> dict:
    """Each event's id -> its event, with every parent id resolving."""
    by_id = {e["id"]: e for e in events}
    assert len(by_id) == len(events)
    assert all(e["parent"] is None or e["parent"] in by_id for e in events)
    return by_id


def _ancestors(e: dict, by_id: dict) -> list[str]:
    out = []
    while e["parent"] is not None:
        e = by_id[e["parent"]]
        out.append(e["name"])
    return out


# a span of the cadence -> the spans it sits in, innermost first, in run_cadence
CADENCE_TREE = {
    "delta_validate": ["ingest", "cadence"],
    "delta_edits": ["ingest", "cadence"],
    "delta_plan": ["ingest", "cadence"],
    "unpacker": ["dispatch", "cadence"],
    "replay": ["dispatch", "cadence"],
    "solve": ["solve_fence", "cadence"],
    "power_iteration": ["solve", "solve_fence", "cadence"],
    "stage": ["solve", "solve_fence", "cadence"],
    "solve_wait": ["absorb", "cadence"],
    "unpack": ["tenant_absorb", "absorb", "cadence"],
    "drift": ["tenant_absorb", "absorb", "cadence"],
    "convergence": ["tenant_absorb", "absorb", "cadence"],
}


@pytest.mark.parametrize("tenants", [1, 2])
def test_cadence_spans_nest_with_parent_ids(tenants):
    """run_cadence's spans: every span of the table where the work happens,
    each inside its parents by id and by time, in the order the work runs;
    the cadence carries its index, the solve its tenants, mode and path."""
    sched = _scheduler(tenants)
    tr = Tracer()
    telemetry.set_tracer(tr)
    rng = np.random.default_rng(5)
    sched.run_cadence({f"t{t}": _mixed_delta(BASE, rng) for t in range(tenants)})
    events = tr.events()
    by_id = _chain(events)
    for e in events:
        if e["name"] in CADENCE_TREE:
            assert _ancestors(e, by_id) == CADENCE_TREE[e["name"]], e["name"]
            parent = by_id[e["parent"]]
            assert parent["ts"] <= e["ts"] and e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 1e-3
    names = [e["name"] for e in events]
    assert set(CADENCE_TREE) <= set(names)
    assert names.count("solve") == 1 and names.count("stage") == len(SPANS_CFG.warm_gammas)
    assert names.count("delta_edits") == names.count("unpacker") == names.count("unpack") == tenants
    (cad,) = [e for e in events if e["name"] == "cadence"]
    assert cad["args"] == {"driver": "sync", "index": 0, "tenants": tenants}
    (solve,) = [e for e in events if e["name"] == "solve"]
    assert solve["args"] == {"tenants": [f"t{t}" for t in range(tenants)], "mode": "warm",
                             "batched": tenants > 1}
    start = {e["name"]: e["ts"] for e in reversed(events)}  # each name's first start
    order = ["delta_validate", "delta_edits", "delta_plan", "unpacker", "replay", "solve",
             "power_iteration", "stage", "solve_wait", "unpack", "drift", "convergence"]
    assert sorted(order, key=start.get) == order
    assert not any("device_ms" in e["args"] for e in events)  # the CPU has no device clock


def test_pipeline_solve_is_parented_to_its_cadence():
    """In run_pipeline the solves run on the solver thread: each `solve`
    span is on another thread than its cadence and names that cadence's id
    as its parent, and the solve's own spans nest under it there."""
    sched = _scheduler()
    tr = Tracer()
    telemetry.set_tracer(tr)
    rng = np.random.default_rng(6)
    sched.run_pipeline([{"t0": _mixed_delta(BASE, rng)}, {"t0": _mixed_delta(BASE, rng)}])
    events = tr.events()
    by_id = _chain(events)
    cadences = [e for e in events if e["name"] == "cadence"]
    solves = [e for e in events if e["name"] == "solve"]
    assert [c["args"]["index"] for c in cadences] == [0, 1] and len(solves) == 2
    for cad, solve in zip(cadences, solves):
        assert solve["parent"] == cad["id"] and solve["tid"] != cad["tid"]
    for e in events:
        if e["name"] in ("power_iteration", "stage"):
            assert _ancestors(e, by_id)[:2] == ["solve", "cadence"]
        if e["name"] in ("delta_validate", "delta_edits", "delta_plan"):
            assert _ancestors(e, by_id)[0] in ("pipeline_ingest", "overlap_ingest")
        if e["name"] in ("unpacker", "replay"):
            assert _ancestors(e, by_id)[:2] == ["dispatch", "cadence"]
        if e["name"] in ("unpack", "drift", "convergence"):
            assert _ancestors(e, by_id)[:3] == ["tenant_absorb", "absorb", "cadence"]
    assert {"delta_rebucketize"}.isdisjoint(e["name"] for e in events)


def test_rebucketize_fallback_has_its_span():
    from repro_torch.instances import DeltaIngestor as Ingestor

    ing = Ingestor(BASE, row_headroom=4)
    s = int(BASE.src[0])
    have = set(BASE.dst[BASE.src == s].tolist())
    # an edge to every destination: beyond the widest bucket
    dst = [d for d in range(BASE.spec.num_destinations) if d not in have]
    rep = ing.apply(InstanceDelta(insert_src=[s] * len(dst), insert_dst=dst,
                                  insert_values=np.ones(len(dst)),
                                  insert_coeff=np.ones((BASE.spec.num_families, len(dst)))))
    events = telemetry.get_tracer().events()
    names = [e["name"] for e in events]
    # the ingestor's first pack, then the fallback's re-pack inside its span
    assert rep.rebucketized and names == ["pack", "delta_validate", "pack",
                                          "delta_rebucketize"]
    assert events[2]["parent"] == events[3]["id"] and events[0]["parent"] is None


@pytest.mark.parametrize("sigma", [False, True])
def test_agd_engine_spans_match_the_maximizer(sigma):
    """agd_raw_solve (the cadence path) emits the Maximizer's spans: the
    power iteration when it runs, then one `stage` per gamma, same args;
    the batched engine emits them once for all its lanes."""
    cfg = MaximizerConfig(gammas=(1.0, 0.1, 0.01), iters_per_stage=5)
    lam0 = torch.zeros(PACKED.dual_dim)
    Maximizer(MatchingObjective(PACKED), cfg).solve()
    want = [(e["name"], e["args"]) for e in telemetry.get_tracer().events()]
    for run in ("solo", "batched"):
        telemetry.get_tracer().reset()
        sig = torch.tensor(2.0) if sigma else None
        if run == "solo":
            agd_raw_solve(PACKED, lam0, cfg, normalize=False, sigma_sq=sig)
        else:
            agd_raw_solve_batched(stack_instances([PACKED, PACKED]), torch.stack([lam0, lam0]),
                                  cfg, normalize=False,
                                  sigma_sq=None if sig is None else sig.repeat(2))
        got = [(e["name"], e["args"]) for e in telemetry.get_tracer().events()]
        assert got == (want[1:] if sigma else want), run


@pytest.mark.parametrize("device", [None, torch.device("cpu")])
def test_device_clock_adds_nothing_on_the_cpu(device):
    tr = telemetry.get_tracer()
    with telemetry.span("outer", device=device, k=1):
        with telemetry.span("inner", device=device):
            torch.ones(8).sum()
    events = tr.events()
    assert [e["args"] for e in events] == [{}, {"k": 1}]
    assert not tr._pending
    assert events[0]["parent"] == events[1]["id"] and events[1]["parent"] is None


def test_explicit_parent_and_span_fields():
    tr = telemetry.get_tracer()
    with telemetry.span("a") as a:
        assert tr.current() is a
        done = threading.Event()

        def other():
            with telemetry.span("b", parent=a.id):
                with telemetry.span("c"):
                    pass
            done.set()

        threading.Thread(target=other).start()
        assert done.wait(10)
    by_name = {e["name"]: e for e in tr.events()}
    assert by_name["b"]["parent"] == by_name["a"]["id"]
    assert by_name["c"]["parent"] == by_name["b"]["id"]
    assert not {"wall0", "depth"} & set(tracing.Span.__slots__)
    assert tracing.Span.__slots__ == ("name", "args", "t0", "id", "parent")


def test_delta_edits_counted_per_op():
    """`delta_edits_total{op}` grows by each op's count in the delta."""
    reg = telemetry.get_registry()
    ing = DeltaIngestor(BASE, row_headroom=4)
    rng = np.random.default_rng(8)
    for n_update in (6, 9):
        before = {op: reg.counter_value("delta_edits_total", op=op) or 0
                  for op in ("insert", "delete", "update")}
        ing.apply(_mixed_delta(ing.to_edge_list(), rng, n_update))
        grown = {op: reg.counter_value("delta_edits_total", op=op) - before[op]
                 for op in before}
        assert grown == {"insert": 3, "delete": 2, "update": n_update}
    assert reg.counter_total("delta_edits_total") == 2 * 5 + 6 + 9


def test_span_cost_microbenchmark_runs_and_restores_the_tracer():
    """`tools/span_readings.py --span-cost`: a row of positive microseconds
    per round for each case, the caller's tracer installed again after, and
    the cases' spans recorded into their own tracers, not the caller's."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "span_readings.py"
    spec = importlib.util.spec_from_file_location("span_readings", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tr = telemetry.get_tracer()
    rows = mod.span_cost(2, n=500)
    assert len(rows) == 2
    for row in rows:
        assert set(row) == {"off", "on", "off_device", "on_device"}
        assert all(v > 0 for v in row.values())
    assert telemetry.get_tracer() is tr and tr.events() == []


# -- convergence traces + stall detection --------------------------------------


def _summaries_equal(got: dict, want: dict, b_norm: float) -> None:
    residuals = ("grad_norm_final", "max_violation_final")
    assert set(got) == set(want)
    for k in got:
        if k == "g_final":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        elif k in residuals:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * b_norm)
        else:
            assert got[k] == want[k], k


B_NORM = float(np.linalg.norm(PACKED_J.rhs))


def test_convergence_trace_from_solve_matches_reference(jax_start_vector):
    cfg = dict(iters_per_stage=120, tol_grad=1e-4, tol_viol=1e-4)
    want = JaxMaximizer(JaxObjective(PACKED_J), JaxConfig(**cfg)).solve()
    res = Maximizer(MatchingObjective(PACKED), MaximizerConfig(**cfg)).solve()
    assert res.iters_used == tuple(int(u) for u in want.iters_used)
    trace = ConvergenceTrace.from_result(res, tenant="t0", engine="agd")
    jtrace = jtel.ConvergenceTrace.from_result(want, tenant="t0", engine="agd")
    s = trace.summary()
    _summaries_equal(s, jtrace.summary(), B_NORM)
    assert s["iters_used"] == list(res.iters_used)
    assert len(trace.stages) == len(MaximizerConfig().gammas)
    for st, used in zip(trace.stages, res.iters_used):
        assert st.g.shape == (used,)
        assert st.budget == MaximizerConfig(**cfg).stage_iter_budget
    assert set(SCHEMA["convergence"]) <= set(s)
    trace.record()
    reg = telemetry.get_registry()
    assert reg.counter_value(
        "convergence_solves_total", tenant="t0", engine="agd", mode="oneshot"
    ) == 1
    assert reg.counter_total("convergence_iters_total") == sum(res.iters_used)


def test_stall_detector_matches_reference(jax_start_vector):
    """An impossible tolerance on a tiny budget exhausts every stage: the
    solve is stalled and the tenant is flagged; a healthy solve then clears
    the flag.  Both detectors see the same solves and say the same."""
    stalled = dict(gammas=(1.0, 0.01), iters_per_stage=10, check_every=5,
                   tol_grad=1e-12, tol_viol=1e-12)
    ok = dict(gammas=(1.0,), iters_per_stage=300, tol_grad=1e-3, tol_viol=1e-3)
    det, jdet = StallDetector(), jtel.StallDetector()
    for cfg, flagged in ((stalled, True), (ok, False)):
        res = Maximizer(MatchingObjective(PACKED), MaximizerConfig(**cfg)).solve()
        want = JaxMaximizer(JaxObjective(PACKED_J), JaxConfig(**cfg)).solve()
        trace = ConvergenceTrace.from_result(res, tenant="t0")
        jtrace = jtel.ConvergenceTrace.from_result(want, tenant="t0")
        _summaries_equal(trace.summary(), jtrace.summary(), B_NORM)
        assert trace.stalled == flagged
        assert det.observe(trace) is jdet.observe(jtrace) is flagged
        assert det.flagged == jdet.flagged
    assert res.iters_used == tuple(int(u) for u in want.iters_used)
    reg = telemetry.get_registry()
    assert reg.counter_value("convergence_stalled_solves_total", tenant="t0") == 1
    assert prometheus_text(reg) == jtel.prometheus_text(jtel.get_registry())


@pytest.mark.parametrize("tol,max_iters", [(1e-3, 400), (1e-12, 100)])
def test_pdhg_stats_parity(jax_start_vector, tol, max_iters):
    """The COO PDHG baseline emits the AGD stats layout, so one
    ConvergenceTrace covers both engines; its trace equals the reference's."""
    cfg = dict(max_iters=max_iters, check_every=50, tol=tol)
    res = tpdhg.solve_pdhg(tpdhg.from_edge_list(BASE, device="cpu"), tpdhg.PDHGConfig(**cfg))
    want = jax_solve_pdhg(jax_from_edge_list(BASE_J), JaxPDHGConfig(**cfg))
    assert len(res.stats) == 1
    assert res.stats[0].g.shape == (max_iters // 50,)
    assert res.iters_used == (res.iters,) == (int(want.iters),)
    kw = dict(engine="pdhg", trace_stride=50, stage_budget=max_iters)
    trace = ConvergenceTrace.from_result(res, **kw)
    # PDHG's trace holds relative residuals (scale 1)
    _summaries_equal(trace.summary(), jtel.ConvergenceTrace.from_result(want, **kw).summary(), 1.0)
    st = trace.stages[0]
    assert st.g.shape == (-(-st.iters_used // 50),)
    assert st.converged == bool(res.converged)
    assert trace.stalled == (not bool(res.converged)) == (not bool(want.converged))


# -- instrumented subsystems ---------------------------------------------------


def test_engine_compile_cache_metrics():
    reg = telemetry.get_registry()
    cfg = MaximizerConfig(gammas=(0.1,), iters_per_stage=10)
    fn = compiled_solver(cfg)
    lam0 = torch.zeros(PACKED.dual_dim)
    base = reg.counter_value("engine_compiles_total", entry="single")
    fn(PACKED, lam0)  # first call on this shape key: a "compile"
    assert reg.counter_value("engine_compiles_total", entry="single") == base + 1
    assert reg.counter_total("engine_compile_seconds_total") > 0
    hits = reg.counter_value("engine_cache_hits_total", entry="single")
    fn(PACKED, lam0)  # same shapes: cache hit
    assert reg.counter_value("engine_cache_hits_total", entry="single") == hits + 1
    assert reg.counter_value("engine_compiles_total", entry="single") == base + 1


def test_delta_ingest_metrics_and_rejections():
    reg = telemetry.get_registry()
    ing = DeltaIngestor(BASE, row_headroom=4)
    ing.telemetry_tenant = "t9"
    rep = ing.apply(_perturb_delta(BASE, np.random.default_rng(3)))
    assert rep.in_place
    assert reg.counter_value("deltas_applied_total", tenant="t9", path="in_place") == 1
    assert reg.counter_value("delta_edits_total", op="update") == rep.n_update
    assert reg.counter_value("scatter_bytes_total", tenant="t9") == rep.plan.nbytes
    assert reg.counter_value("scatter_cells_total", tenant="t9") == rep.plan.num_cells
    with pytest.raises(ValueError):
        ing.apply(InstanceDelta(delete_src=[SPEC["num_sources"] + 1], delete_dst=[0]))
    assert reg.counter_value("delta_rejections_total", tenant="t9") == 1
    assert reg.counter_value("deltas_applied_total", tenant="t9", path="in_place") == 1


# -- prometheus exposition -----------------------------------------------------


def test_prometheus_text_exposition():
    reg = telemetry.get_registry()
    reg.inc("solves_total", 3, tenant="a")
    reg.set_gauge("depth", 2)
    reg.observe("lat_seconds", 0.2)
    text = prometheus_text(reg)
    assert '# TYPE solves_total counter' in text
    assert 'solves_total{tenant="a"} 3' in text
    assert '# TYPE depth gauge' in text
    assert '# TYPE lat_seconds histogram' in text
    assert 'lat_seconds_bucket{le="+Inf"} 1' in text
    assert 'lat_seconds_count 1' in text
    counts = [
        int(l.rsplit(" ", 1)[1])
        for l in text.splitlines()
        if l.startswith("lat_seconds_bucket")
    ]
    assert counts == sorted(counts)


def test_write_prometheus_atomic(tmp_path):
    reg = telemetry.get_registry()
    reg.inc("x_total", 1)
    path = str(tmp_path / "m.prom")
    telemetry.write_prometheus(path, reg)
    assert "x_total 1" in open(path).read()
    assert list(tmp_path.iterdir()) == [tmp_path / "m.prom"]  # no tmp litter
