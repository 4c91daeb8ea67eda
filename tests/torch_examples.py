"""Helpers of tests/test_torch_examples_*.py: run a reference example in a
child interpreter, load a port example in this one, read printed figures.

The reference's examples are never imported into the test process
(examples/train_lm.py configures logging on import).  Both sides run on one
thread: the examples' arrays are small, so one thread does them as fast as
eight, and the other cores stay with the other test workers.
"""
import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_example(name: str):
    """examples/<name>.py as a module (examples/ is not a package)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference_run(example: str, args=(), runner=None, runner_args=()):
    """`python examples/<example>.py args` of the JAX package on the CPU, or
    `python -c runner runner_args examples/<example>.py args` (a runner
    patches the package, then runs the example through `runpy`)."""
    path = os.path.join(REPO, "examples", f"{example}.py")
    cmd = [sys.executable, path] if runner is None else [
        sys.executable, "-c", runner, *runner_args, path]
    xla = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{xla} --xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1".strip())
    proc = subprocess.run(cmd + list(args), capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's example runs on one thread, as the reference's child does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def field(text: str, pattern: str) -> str:
    """The first group of `pattern`'s first match in `text`."""
    m = re.search(pattern, text)
    assert m, f"{pattern!r} not in:\n{text}"
    return m.group(1)


def close_to_printed(got: float, printed: str, rtol: float) -> bool:
    """`got` within rtol of a printed figure, give or take half a unit of
    its last printed digit (the print's resolution)."""
    mantissa, _, exponent = printed.lower().partition("e")
    decimals = len(mantissa.partition(".")[2])
    want = float(printed)
    return abs(got - want) <= rtol * abs(want) + 0.5 * 10.0 ** (int(exponent or 0) - decimals)


def example_args(mod, *argv):
    """The port example's parsed arguments on the CPU."""
    return mod.build_parser().parse_args(["--device", "cpu", *argv])
