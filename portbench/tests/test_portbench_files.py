"""BENCHMARK.json and the files it names: keys, names, units and limits as the
benchmark contract has them, every file resolving by name, and a new cell
with a new configuration, mix and metric found by adding files alone."""
from __future__ import annotations

import hashlib
import json
import math
import re
import shutil

import pytest

from portbench_tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in b["command"])
    assert len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (b["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(b).encode()) <= 64 * 1024


def test_configs_resolve():
    b = bench()
    assert 1 <= len(b["configs"]) <= 24
    used = {w["config"] for w in b["workloads"]}
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        with open(ROOT / c["file"]) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert sorted(c["reduced"]) == sorted(data["reduced"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads_and_metrics_resolve():
    from portbench import run

    b = bench()
    assert 1 <= len(b["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert line(w["why"])
        r = run.load_cell(ROOT, w["name"])
        reported = {m["name"] for m in r["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2 and r["per_layer"]
        for m in r["per_layer"]:  # each moves a metric that the cell reports
            assert m["moves"] in reported
        assert (ROOT / "portbench" / "drivers" / f"{r['traffic']['driver']}.py").exists()
        assert all(math.isfinite(v) and v >= 0 for v in r["limits"].values())


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or "_cache" in rel.split("/"):
            continue
        assert all(NAME.match(part) for part in rel.split("/")), rel


def _digest(root) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_is_found_by_added_files_alone(tmp_path):
    """A configuration, a mix, a per-layer metric and a cell, each a file
    added to a copy of the checkout: the harness resolves them by name, and
    no file that was there changes."""
    from portbench import run

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "match-s1M-d10K.json").read_text())
    cfg.update(name="match-s2M-d10K", num_sources=2_000_000)
    (pb / "configs" / "match-s2M-d10K.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "solve.json").read_text())
    mix.update(iters_per_stage=50)
    (pb / "traffic" / "solve-short.json").write_text(json.dumps(mix))
    (pb / "limits" / "s2m-solve-short.json").write_text(
        (pb / "limits" / "s3.5m-solve.json").read_text())
    (pb / "metrics" / "units_traced.solve.py").write_text(
        "def read(trace):\n    p = trace.get('profiled')\n    return None if p is None else p.units\n")
    b = bench()
    b["configs"].append(dict(b["configs"][0], name="match-s2M-d10K",
                             file="portbench/configs/match-s2M-d10K.json"))
    b["workloads"].append({"name": "s2m-solve-short", "config": "match-s2M-d10K",
                           "traffic": "solve-short", "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "units_traced.solve", "unit": "count", "better": "higher",
                           "source": "program_counter", "layer": "device", "moves": "solve_s",
                           "workloads": ["s2m-solve-short"]})
    b["end_to_end"][0]["workloads"].append("s2m-solve-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    r = run.load_cell(tmp_path, "s2m-solve-short")
    assert r["config"]["num_sources"] == 2_000_000 and r["traffic"]["iters_per_stage"] == 50
    assert "units_traced.solve" in [m["name"] for m in r["per_layer"]]
    assert {m["name"] for m in r["end_to_end"]} == {"solve_s", "setup_s"}
    reader = run._load(tmp_path, "metrics", "units_traced.solve").read
    assert reader({"profiled": None}) is None
    after = _digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    with pytest.raises(SystemExit):
        run.load_cell(tmp_path, "no-such-cell")
