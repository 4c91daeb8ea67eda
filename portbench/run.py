"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on one card.

    python3 -m portbench.run --workload s3.5m-solve --seed 7 --seconds 30 --trace 0

from the root of a checkout.  The cell (`BENCHMARK.json` `workloads`) names a
configuration (`portbench/configs/<config>.json`) and a traffic mix
(`portbench/traffic/<traffic>.json`), and the mix names its driver
(`portbench/drivers/<driver>.py`); the limits of the cell's comparison with
the reference are `portbench/limits/<workload>.json`, and each per-layer
metric is read by `portbench/metrics/<metric>.py`.  All are found by name, so
a new configuration, mix, driver or metric is a new file.

A run makes its inputs from `--seed`, packs them through the port, warms up
the cell's shapes (set-up), runs the traffic driver's closed loop for `--seconds`,
then compares what the window produced with the float64 reference in
`portbench/reference/`, and prints one JSON line last: the end-to-end metrics
with `--trace 0`, the per-layer metrics with `--trace 1` (which also profiles
a short stretch after the window).  With no card, or fewer than the cell
asks for, it prints no result and exits 2; if JAX or the JAX package is
loaded once the window has closed, it exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # before any heavy import: the start of set-up

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

__all__ = ["Context", "load_cell", "execute", "emit", "main", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entry, configuration, traffic mix, limits and metrics, all
    resolved by name under `root` (a checkout)."""
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    pkg = root / "portbench"
    config = _read(pkg / "configs" / f"{cell['config']}.json")
    traffic = _read(pkg / "traffic" / f"{cell['traffic']}.json")
    limits = _read(pkg / "limits" / f"{workload}.json")

    def applies(metric, moves_ok=True):
        ws = metric.get("workloads")
        return workload in ws if ws is not None else moves_ok

    end_to_end = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"] if applies(m, m["moves"] in names)]
    return {"cell": cell, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": end_to_end, "per_layer": per_layer, "root": root}


def _load(root: Path, kind: str, name: str):
    """The module `portbench/<kind>/<name>.py` of the checkout at `root`."""
    path = root / "portbench" / kind / f"{name}.py"
    mod_name = f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a driver gets: the cell's data, the seed, the window's length, the
    device, and the set-up clock, whose parts it names as it goes."""

    def __init__(self, resolved: dict, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, control: bool = False):
        self.cell, self.config = resolved["cell"], resolved["config"]
        # the slab dtype the program runs: the configuration's, or for the
        # control of the comparison the next precision below (float32 ->
        # bfloat16, the port's narrow-slab path)
        self.slab_dtype = {"float32": "bfloat16"}[self.config["slab_dtype"]] if control \
            else self.config["slab_dtype"]
        self.traffic = resolved["traffic"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.t_start = t_start
        self.parts: dict[str, float] = {}
        self._mark = t_start
        self.window_start = None
        self.peak_bytes = None
        self.builds = 0.0  # seconds of nvcc builds inside set-up

    def part(self, name: str) -> None:
        """Close a part of set-up: the time since the last part."""
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self._mark
        self._mark = now

    @contextlib.contextmanager
    def setup(self, name: str):
        self.part("other")
        yield
        self.sync()
        self.part(name)

    def sync(self) -> None:
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()

    def build_kernels(self, names) -> None:
        """Build the port's named kernels now, so that set-up shows the
        builds apart (`builds` stays 0 when the checkout has them)."""
        if not self.device.startswith("cuda"):
            return
        from repro_torch.kernels import build

        self.builds = max(build.build(names).values(), default=0.0)

    def closed_loop(self, step) -> tuple[list, float]:
        """`step(i)` back to back (each ends synchronised) until `seconds`
        have passed; (outputs, seconds of the whole units run)."""
        self.part("other")
        self.sync()
        t0 = self.window_start = time.perf_counter()
        outs = []
        while True:
            outs.append(step(len(outs)))
            elapsed = time.perf_counter() - t0
            if elapsed >= self.seconds:
                break
        if self.device.startswith("cuda"):
            import torch

            self.peak_bytes = int(torch.cuda.max_memory_allocated())
        return outs, elapsed


def _finite(v: float) -> float:
    """A number JSON can carry: infinities and NaN (which no limit passes)
    become +-1e308."""
    if math.isfinite(v):
        return v
    return -1e308 if v == -math.inf else 1e308


def _power_limit() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "not measured"
    r = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=30)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "not measured"


def execute(resolved: dict, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", t_start: float | None = None,
            control: bool = False) -> dict:
    """One run of a resolved cell on `device`; returns the result line's
    object (without printing).  `control` runs the program one precision
    below the configuration's (the comparison's control, which the
    benchmark's own runs never take)."""
    root = resolved["root"]
    if str(root / "src") not in sys.path:
        sys.path.insert(0, str(root / "src"))
    ctx = Context(resolved, seed, seconds, trace, device,
                  T_START if t_start is None else t_start, control)
    out = _load(root, "drivers", resolved["traffic"]["driver"]).run(ctx)

    loaded = sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))
    if loaded:
        raise ForbiddenImport(loaded)

    limits = resolved["limits"]
    missing = sorted(set(limits) - set(out["checks"]))
    if missing:
        raise KeyError(f"the traffic driver gave no reading of {missing}")
    checks = {k: {"value": _finite(float(v)), "limit": limits[k]}
              for k, v in out["checks"].items() if k in limits}
    readings = {k: _finite(float(v)) for k, v in out["checks"].items() if k not in limits}
    correct = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    import torch

    dev = {"platform": "gpu" if device.startswith("cuda") else device,
           "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
           "count": 1,
           "memory_peak_bytes": ctx.peak_bytes,
           "power_limit": _power_limit() if device.startswith("cuda") else "not measured"}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        data = out["trace"]
        metrics = {}
        for m in resolved["per_layer"]:
            v = _load(root, "metrics", m["name"]).read(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        p = data["profiled"]
        dev.update(busy_s=p.busy_s, window_s=p.window_s)
        result.update(metrics=metrics, device=dev, breakdown=p.breakdown())
    else:
        # a checkout's first run builds the kernels: recorded apart, in setup_parts
        values = dict(out["metrics"], setup_s=ctx.window_start - ctx.t_start - ctx.builds)
        result.update(metrics={m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                               for m in resolved["end_to_end"]}, device=dev)
    result["setup_parts"] = dict(ctx.parts, builds=ctx.builds)
    result["readings"] = readings  # numbers the cell does not compare
    result["checks"] = checks  # last: the numbers compared, each beside its limit
    return result


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    caches = root / "portbench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(caches / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(caches / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(caches / "cuda")
    resolved = load_cell(root, args.workload)

    import torch

    chips = int(resolved["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = execute(resolved, args.seed, args.seconds, bool(args.trace))
    except ForbiddenImport as e:
        print(f"portbench: modules loaded in the measured process: {e.args[0]}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """Print a run's result: the set-up parts on an earlier line, the
    numbers not compared and then each compared number beside its limit as
    the last lines of standard error, and the result line last."""
    result = dict(result)
    print("setup_parts " + json.dumps(result.pop("setup_parts")), flush=True)
    for name, v in result.pop("readings").items():
        print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
