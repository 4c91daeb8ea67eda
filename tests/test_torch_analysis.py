"""The port's analysis of LM cells against the JAX package's.

  * `analysis.flops_model.cell_cost` equal, field for field with `==`, to
    the reference's for the ten archs x `SHAPES` and the reference test's
    `ShapeSpec("tiny_train", "train", 64, 4)`.
  * The counterpart of tests/test_analysis.py::test_flops_model_validates_against_hlo:
    `FlopCounterMode`'s count of the reduced qwen3-8b train step (an eager
    step runs every layer, so the whole analytic total is the prediction)
    inside the reference's band 0.4-2.5.
  * `analysis.comm_stats` on a fake-group trace of a hand-checked sharded
    product (in a child process: the fake group is joined only there).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.analysis.flops_model import cell_cost as rcell_cost  # noqa: E402
from repro import configs as rconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.analysis import comm_stats  # noqa: E402
from repro_torch.analysis.flops_model import cell_cost  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training import AdamWConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.training.loop import batch_to_device  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TINY = ("tiny_train", "train", 64, 4)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cell_cost_equals_reference(arch):
    shapes = [(s, rconfigs.SHAPES[n]) for n, s in tconfigs.SHAPES.items()]
    shapes.append((tconfigs.ShapeSpec(*TINY), rconfigs.ShapeSpec(*TINY)))
    for tshape, rshape in shapes:
        got = cell_cost(tconfigs.get_config(arch), tshape)
        want = rcell_cost(rconfigs.get_config(arch), rshape)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), tshape.name


def test_flop_counter_validates_the_flops_model():
    """FlopCounterMode over one eager train step of the reduced qwen3-8b
    (remat on, as the full config trains) against `cell_cost`: every layer
    runs, so measured / cost.flops must sit in the reference's 0.4-2.5."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(tconfigs.get_reduced_config("qwen3-8b"), remat=True)
    shape = tconfigs.ShapeSpec(*TINY)
    cost = cell_cost(cfg, shape)
    model = Model(cfg)
    state = init_train_state(model, device="cpu")
    step, _, _ = make_train_step(model, AdamWConfig())
    batch = batch_to_device(SyntheticLMData(cfg, batch=4, seq=64, seed=0)(0), "cpu")
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    ratio = fc.get_total_flops() / cost.flops
    print(json.dumps({"measured": fc.get_total_flops(), "predicted": cost.flops,
                      "ratio": ratio}))
    assert 0.4 < ratio < 2.5, ratio
    assert cost.flops == pytest.approx(
        4 * cost.layer_fwd_flops * cfg.num_layers + cost.extra_flops, rel=0.01)


CHILD = r"""
import json
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.analysis.comm_stats import TraceCounter, collective_stats
from repro_torch.launch.mesh import make_production_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_production_mesh(device_type="cpu")
a = DTensor.from_local(torch.ones(16, 64), mesh, [Shard(0), Replicate()], run_check=False)
b = DTensor.from_local(torch.ones(4, 2), mesh, [Shard(0), Shard(1)], run_check=False)
with TraceCounter() as tc, CommDebugMode() as cm:
    c = a @ b
st = collective_stats(tc)
print(json.dumps({"counts": st["counts"], "bytes": st["bytes"], "total": st["total_bytes"],
                  "flops": tc.flops, "debug": sum(cm.get_comm_counts().values()),
                  "out": [str(p) for p in c.placements], "local": list(c.to_local().shape)}))
"""


def test_collective_stats_of_a_sharded_product():
    """[256, 64] (data-sharded rows) @ [64, 32] (rows over data, columns over
    model) on the (16, 16) mesh: B's rows are gathered over `data` (one
    all-gather whose operand is B's local [4, 2] fp32 shard, 32 bytes), then
    each device multiplies its [16, 64] rows by a [64, 2] column block."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["counts"] == {"all-gather": 1} and got["debug"] == 1
    assert got["bytes"] == {"all-gather": 4 * 2 * 4} and got["total"] == 32
    assert got["flops"] == 2 * 16 * 64 * 2
    assert got["out"] == ["S(0)", "S(1)"] and got["local"] == [16, 2]


def test_collective_stats_sums_by_kind():
    ops = [("all-gather", 32, (4, 2)), ("all-reduce", 8, (2,)), ("all-gather", 16, (2, 2))]
    got = comm_stats.collective_stats(ops)
    assert got["counts"] == {"all-gather": 2, "all-reduce": 1}
    assert got["bytes"] == {"all-gather": 48, "all-reduce": 8}
    assert got["total_bytes"] == 56 and got["ops"] == ops
