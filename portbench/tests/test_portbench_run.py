"""A run end to end on the CPU at a tiny size: the result line's keys, the
reference against the port, the generator's draws, and the
guard against JAX and the JAX package in the measured process."""
from __future__ import annotations

import ast
import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from portbench_tiny import ROOT, tiny

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def card():
    """Skips where no NVIDIA card is present (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _printed(result: dict) -> tuple[list[str], list[str]]:
    from portbench import run

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        run.emit(result)
    return out.getvalue().splitlines(), err.getvalue().splitlines()


@pytest.mark.parametrize("workload,trace", [("s3.5m-solve", False), ("s3.5m-solve", True),
                                            ("s1m-cadence", True)])
def test_tiny_run_prints_the_contract_line(workload, trace):
    from portbench import run

    result = run.execute(tiny(workload), 20260101, 0.2, trace, device="cpu")
    out, err = _printed(result)
    last = json.loads(out[-1])
    extra = ["breakdown"] if trace else []
    assert list(last) == CONTRACT + extra + ["checks"]
    assert out[0].startswith("setup_parts ")
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
    assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    checks = last["checks"]
    assert checks and all(c["value"] <= c["limit"] for c in checks.values())
    assert err[-len(checks):] == [f"check {k} {c['value']!r} limit {c['limit']!r}"
                                  for k, c in checks.items()]
    if trace:
        assert set(last["device"]) >= {"busy_s", "window_s"}
    else:
        r = tiny(workload)
        assert set(last["metrics"]) == {m["name"] for m in r["end_to_end"]}
        assert all(v["value"] > 0 for v in last["metrics"].values())


def test_generator_draws_appendix_a():
    """Appendix A on the device: the same seed draws the same edge list,
    another seed another; pairs are distinct and sorted, values are capped,
    each family's coefficients are a per-destination scale times the value,
    and each rhs is rho in [0.5, 1] times the greedy load plus eps, the greedy
    load worked out here again in plain numpy."""
    from portbench.generator import generate

    cfg = dict(tiny("s3.5m-solve")["config"], num_families=2)
    I, J = cfg["num_sources"], cfg["num_destinations"]
    for seed in (0, 7, 2**31 + 5):
        e = generate(cfg, seed)
        again, other = generate(cfg, seed), generate(cfg, seed + 1)
        for k in ("src", "dst", "values", "coeff", "rhs"):
            assert np.array_equal(getattr(e, k), getattr(again, k)), (seed, k)
        assert not np.array_equal(e.values[:100], other.values[:100])
        keys = e.src * J + e.dst
        assert np.all(np.diff(keys) > 0) and e.src.max() < I and e.dst.max() < J
        assert 0.6 * cfg["avg_degree"] < e.nnz / I < 1.05 * cfg["avg_degree"]  # fewer: repeats drop
        assert np.all(e.values > 0) and np.all(e.values <= cfg["c_max"])
        for k in range(2):
            scale = e.coeff[k] / e.values
            per_dst = np.full(J, np.nan)
            per_dst[e.dst] = scale
            assert np.allclose(scale, per_dst[e.dst], rtol=1e-12)
            load = np.zeros(J)
            for i in np.unique(e.src):
                rows = np.flatnonzero(e.src == i)
                w = rows[np.argmax(e.coeff[k][rows])]
                load[e.dst[w]] += e.coeff[k][w]
            rho = e.rhs[k * J:(k + 1) * J] / (load + cfg["rhs_eps"])
            assert np.all(rho >= 0.5 - 1e-12) and np.all(rho <= 1.0 + 1e-12)


def test_delta_pool_applies_cleanly_and_repeats():
    from portbench.generator import delta_pool, generate
    from portbench.reference.matching import EdgeState

    r = tiny("s1m-cadence")
    edges = generate(r["config"], 3)
    pools = [delta_pool(edges, r["traffic"], 3, 6) for _ in range(2)]
    for a, b in zip(*pools):
        assert all(np.array_equal(getattr(a, k), getattr(b, k)) for k in vars(a))
    state = EdgeState(edges.num_sources, edges.num_destinations, edges.num_families,
                      edges.src, edges.dst, edges.values, edges.coeff, edges.rhs)
    for d in pools[0]:
        state.apply(d)
        assert d.update_src.size == int(r["traffic"]["update_share"] * edges.nnz)
    inst = state.instance("cpu")
    assert inst.src.numel() == edges.nnz  # three inserts and three deletes a delta


def test_reference_oracle_matches_the_port_at_random_duals():
    """The float64 reference and the port's plain path agree on x, A x and g
    at random duals of a small seeded instance."""
    import torch

    from portbench import port
    from portbench.generator import generate
    from portbench.reference.matching import RefInstance, oracle
    from repro_torch.core import MatchingObjective, normalize_rows
    from repro_torch.instances import bucketize, unpack_primal

    cfg = tiny("s3.5m-solve")["config"]
    edges = generate(cfg, 11)
    packed = bucketize(port.edge_list(edges, cfg), device="cpu")
    scaled, _ = normalize_rows(packed)
    ref, _ = RefInstance.build(edges.num_sources, edges.num_destinations, edges.num_families,
                               edges.src, edges.dst, edges.values, edges.coeff, edges.rhs,
                               "cpu").scaled()
    lam = torch.rand(scaled.dual_dim, generator=torch.Generator().manual_seed(1))
    for gamma in (1.0, 0.01):
        ev = MatchingObjective(scaled).calculate(lam, gamma)
        g, grad, x = oracle(ref, lam.double(), gamma)
        x_port = torch.as_tensor(unpack_primal(packed, ev.x_slabs))
        assert float((x_port - x).abs().max()) < 1e-4
        assert float((ev.grad.double() - grad).abs().max()) < 1e-4 * float(grad.abs().max())
        assert abs(float(ev.g) - float(g)) < 1e-5 * abs(float(g))


GUARD = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
from portbench import run
from portbench_tiny import tiny
run.execute(tiny("s3.5m-solve"), 5, 0.1, False, device="cpu")
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_no_jax_in_the_measured_process():
    from portbench.run import FORBIDDEN

    code = GUARD.format(root=str(ROOT), src=str(ROOT / "src"),
                        tests=str(ROOT / "portbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & set(FORBIDDEN)


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_neither_jax_nor_the_program_in_the_reference():
    from portbench.run import FORBIDDEN

    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & set(FORBIDDEN), path
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        own = [n.module for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and n.module.startswith("portbench")]
        assert "repro_torch" not in _imports(path), path
        assert all(m.startswith("portbench.reference") for m in own), path


def test_without_a_card_a_run_prints_nothing_and_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "s3.5m-solve",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
def test_on_the_card_a_tiny_cell_is_correct(card):
    from portbench import run

    result = run.execute(tiny("s3.5m-solve"), 9, 0.5, True, device="cuda")
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.cuda
def test_on_the_card_benchmark_files_alone_do_not_run(card, tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "s3.5m-solve",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.parametrize("value,want", [(float("nan"), 1e308), (float("inf"), 1e308),
                                        (float("-inf"), -1e308), (2.5e-7, 2.5e-7)])
def test_non_finite_numbers_fail_their_limit_in_json(value, want):
    from portbench.run import _finite

    assert _finite(value) == want
