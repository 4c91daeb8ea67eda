"""The per-card cell `s25m-solve` at a size the CPU holds: its degree-grouped
float64 reference against `reference/matching.py`, its driver correct where
the program runs at the configuration's precision and not correct in the
bfloat16 control, the readers of its set-up spans, and the driver's refusal
of a program that cannot pack on the card."""
from __future__ import annotations

import importlib.util

import pytest
import torch

from portbench_tiny import ROOT, tiny

SEED = 2147483659


def rel(got, want) -> float:
    got, want = torch.as_tensor(got, dtype=torch.float64), torch.as_tensor(want, dtype=torch.float64)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.fixture(scope="module")
def both():
    from portbench.generator import generate
    from portbench.reference.matching import RefInstance
    from portbench.reference.matching_grouped import GroupedInstance

    cfg = dict(tiny("s25m-solve")["config"], num_families=2)
    e = generate(cfg, SEED)
    args = (e.num_sources, e.num_destinations, e.num_families, e.src, e.dst, e.values,
            e.coeff, e.rhs, "cpu")
    return RefInstance.build(*args).scaled(), GroupedInstance.build(*args).scaled()


def test_grouped_reference_scales_as_the_plain_one(both):
    (plain, d_plain), (grouped, d_grouped) = both
    assert rel(d_grouped, d_plain) <= 1e-12
    assert rel(grouped.rhs, plain.rhs) <= 1e-12
    for name in ("src", "dst", "cost"):
        assert torch.equal(getattr(grouped, name), getattr(plain, name))
    assert rel(grouped.coeff, plain.coeff) <= 1e-12
    degrees = [d for d, _, _ in grouped.blocks]
    assert degrees == sorted(set(degrees)) and len(degrees) > 3
    assert sum(d * n for d, _, n in grouped.blocks) == grouped.src.numel()


@pytest.mark.parametrize("gamma", [1e3, 1.0, 0.01])
def test_grouped_oracle_matches_the_plain_one(both, gamma):
    from portbench.reference import matching, matching_grouped

    (plain, _), (grouped, _) = both
    lam = torch.rand(plain.m * plain.J, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(3)) * 5
    g0, grad0, x0 = matching.oracle(plain, lam, gamma)
    g1, grad1, x1 = matching_grouped.oracle(grouped, lam, gamma)
    assert abs(float(g1) - float(g0)) <= 1e-12 * abs(float(g0))
    assert rel(grad1, grad0) <= 1e-12
    assert rel(x1, x0) <= 1e-12
    assert 0 < float(x0.max()) and float(x0.min()) == 0.0  # some clamped, some not


@pytest.mark.parametrize("scale", [0.05, 1.0, 30.0, 3000.0])
def test_grouped_projection_matches_the_sorted_one(both, scale):
    """Entries anywhere from inside the set to far outside it, with ties."""
    (plain, _), (grouped, _) = both
    gen = torch.Generator().manual_seed(int(scale * 100))
    v = (torch.rand(plain.src.numel(), dtype=torch.float64, generator=gen) - 0.3) * scale
    v[::7] = v[3]  # ties across and within sources
    want = plain.project(v)
    got = grouped.in_edge_order(grouped.project(v[grouped.perm]))
    assert rel(got, want) <= 1e-12
    sums = torch.zeros(plain.I, dtype=torch.float64).index_add_(0, plain.src, got)
    assert float(sums.max()) <= 1.0 + 1e-12 and float(got.min()) >= 0.0


def test_grouped_power_iteration_and_agd_match_the_plain_ones(both):
    from portbench.reference import matching, matching_grouped

    (plain, _), (grouped, _) = both
    s0 = matching.power_iteration(plain, 0, 30)
    s1 = matching_grouped.power_iteration(grouped, 0, 30)
    assert abs(float(s1) - float(s0)) <= 1e-12 * float(s0)
    zero = torch.zeros(plain.m * plain.J, dtype=torch.float64)
    gammas = (1e3, 10.0, 0.1, 0.01)
    lam0, g0, x0 = matching.agd(plain, zero, gammas, 15, s0)
    lam1, g1, x1 = matching_grouped.agd(grouped, zero, gammas, 15, s0)
    assert rel(lam1, lam0) <= 1e-12
    assert abs(g1 - g0) <= 1e-12 * abs(g0)
    assert rel(x1, x0) <= 1e-12


def verdict(control: bool) -> dict:
    from portbench import run

    return run.execute(tiny("s25m-solve"), SEED, 0.2, False, device="cpu", control=control)


def test_tiny_cell_is_correct_and_its_control_is_not():
    sound, control = verdict(False), verdict(True)
    assert sound["correct"] is True and sound["attempted"] >= 1
    assert set(sound["metrics"]) == {"solve_s", "setup_s"}
    assert {"upload", "pack", "normalize", "objective"} <= set(sound["setup_parts"])
    assert control["correct"] is False
    assert [k for k, c in control["checks"].items() if c["value"] > c["limit"]]


def _driver():
    from portbench import run

    return run._load(ROOT, "drivers", "solve_card")


def _context(trace: bool):
    import time

    from portbench import run

    return run.Context(tiny("s25m-solve"), SEED, 0.2, trace, "cpu", time.perf_counter())


def reader(name: str):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


NEW = {"pack_ms.solve_card": "pack", "normalize_ms.solve_card": "normalize"}


def test_traced_run_records_the_setup_spans_and_the_readers_read_them():
    from repro_torch import telemetry

    before = telemetry.get_tracer()
    out = _driver().run(_context(True))
    assert telemetry.get_tracer() is before  # the driver puts the tracer back
    spans = out["trace"]["setup_spans"]
    assert set(spans) == set(NEW.values())
    for span in spans.values():
        assert span["host_ms"] > 0 and span["device_ms"] is None  # no card: no device time
    for name, span in NEW.items():
        read = reader(name)
        assert read(out["trace"]) is None
        assert read({"setup_spans": {span: {"host_ms": 9.0, "device_ms": 4.5}}}) == 4.5


@pytest.mark.parametrize("name", sorted(NEW))
@pytest.mark.parametrize("trace", [{}, {"setup_spans": {}}, {"setup_spans": {"pack": {}}},
                                   {"setup_spans": {"normalize": {"device_ms": None}}}])
def test_readers_return_a_number_or_none(name, trace):
    v = reader(name)(trace)
    assert v is None or isinstance(v, float)


def test_a_program_that_packs_on_the_host_is_refused_before_generating(monkeypatch):
    from repro_torch.instances import EdgeListInstance

    driver = _driver()
    monkeypatch.delattr(EdgeListInstance, "to")
    monkeypatch.setattr(driver, "generate", lambda *a, **k: pytest.fail("generated"))
    with pytest.raises(RuntimeError, match="EdgeListInstance.to"):
        driver.run(_context(False))


def test_the_cell_reports_the_solve_cells_layers():
    from portbench import run

    r = run.load_cell(ROOT, "s25m-solve")
    names = {m["name"] for m in r["per_layer"]}
    assert names == {"oracle_roofline.solve", "iter_mfu.solve", "device_idle.solve",
                     "pack_ms.solve_card", "normalize_ms.solve_card"}
    assert {m["name"] for m in r["end_to_end"]} == {"solve_s", "setup_s"}
    assert r["cell"]["chips"] == 1 and r["traffic"]["driver"] == "solve_card"
    assert r["config"]["num_sources"] == 25_000_000 and r["config"]["reduced"] == {}
