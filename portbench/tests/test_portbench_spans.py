"""The per-layer metrics that read the program's spans inside ingest,
dispatch and absorb: tiny traced CPU runs of both cells still print the
contract line and the cadence's reports them, the readers return a number
or None (never raise) on what any run hands them, and the untraced result
line holds the end-to-end metrics alone."""
from __future__ import annotations

import importlib.util
import json

import pytest

from portbench_tiny import ROOT, tiny

NEW = ["ingest_edit_us.cadence", "unpacker_ms.cadence", "drift_ms.cadence"]


def reader(name: str):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("workload,trace", [("s1m-cadence", True), ("s1m-cadence", False),
                                            ("s3.5m-solve", True)])
def test_tiny_runs_report_the_span_metrics(workload, trace):
    from portbench import run
    from repro_torch import telemetry

    result = run.execute(tiny(workload), 2147483659, 0.2, trace, device="cpu")
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True
    got = line["metrics"]
    if not trace:
        assert set(got) == {m["name"] for m in tiny(workload)["end_to_end"]}
    elif workload == "s1m-cadence":
        for name in NEW:
            assert got[name]["value"] > 0, name
        assert got["unpacker_ms.cadence"]["value"] <= got["dispatch_ms.cadence"]["value"]
        assert got["drift_ms.cadence"]["value"] <= got["absorb_ms.cadence"]["value"]
        reg = telemetry.get_registry()
        per_delta = reg.counter_total("delta_edits_total") / reg.counter_total("deltas_applied_total")
        assert got["ingest_edit_us.cadence"]["value"] == pytest.approx(
            1e3 * got["ingest_ms.cadence"]["value"] / per_delta)
    else:
        assert not set(NEW) & set(got)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("trace", [{}, {"span_ms": {}, "span_units": 0},
                                   {"span_ms": {"ingest": 5.0, "absorb": 1.0}, "span_units": 2}])
def test_readers_return_a_number_or_none(name, trace):
    v = reader(name)(trace)
    assert v is None or isinstance(v, float)
