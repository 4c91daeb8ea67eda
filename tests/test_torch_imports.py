"""The port imports torch and numpy only: every module of `repro_torch`,
imported in a fresh interpreter, brings in no `jax`, no `ml_dtypes` and
nothing of the JAX package `repro`.  The mesh half of the LM substrate is
among them, and importing it joins no process group and loads no fake
group (`torch.testing._internal.distributed.fake_pg`: only the dry run's
child process does)."""
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")
             or m.startswith("torch.testing._internal.distributed"))
mesh_half = {"repro_torch.training.sharding_rules", "repro_torch.launch.mesh",
             "repro_torch.serving.lm_demo.steps", "repro_torch.analysis.flops_model",
             "repro_torch.analysis.comm_stats"}
import torch.distributed as dist
print(len(names), "modules;", "foreign:", bad, "missing:", sorted(mesh_half - set(names)))
sys.exit(1 if bad or len(names) < 65 or mesh_half - set(names) or dist.is_initialized() else 0)
"""


def test_port_imports_no_jax_and_nothing_of_the_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "foreign: []" in proc.stdout
