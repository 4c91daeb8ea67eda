"""The port's sharding rules (`repro_torch.training.sharding_rules`) and
`launch.mesh.default_profile` against the JAX package's, for all ten full
configs on the meshes single_pod (16, 16), multi_pod (2, 16, 16) and
(2, 2), with FSDP off and on.

The reference's shapes come from `jax.eval_shape` and its mesh is a
`jax.sharding.AbstractMesh` (the rules read only `mesh.shape`); the port's
shapes come from the meta device and it reads the same abstract mesh.
Every spec must equal the reference's `PartitionSpec` entry for entry:
params, the batch of every train / prefill shape, and the decode caches
(bf16 and int8).  `placements` is checked on a fake (16, 16) and
(2, 16, 16) mesh in one child process (the fake group is joined only
there).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch.mesh import default_profile as rprofile  # noqa: E402
from repro.models.model import Model as RModel  # noqa: E402
from repro.training import sharding_rules as rrules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch.mesh import default_profile as tprofile  # noqa: E402
from repro_torch.models.config import ShardingProfile  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training import sharding_rules as trules  # noqa: E402

MESHES = {
    "single_pod": AbstractMesh((16, 16), ("data", "model")),
    "multi_pod": AbstractMesh((2, 16, 16), ("pod", "data", "model")),
    "2x2": AbstractMesh((2, 2), ("data", "model")),
}
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _specs(tree):
    """The reference's PartitionSpec tree as plain tuples."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _profiles(mesh):
    dp = ("pod", "data") if "pod" in mesh.shape else ("data",)
    from repro.models.config import ShardingProfile as RProfile

    return [(RProfile(tp_axis="model", dp_axes=dp, fsdp=f),
             ShardingProfile(tp_axis="model", dp_axes=dp, fsdp=f)) for f in (False, True)]


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_pspecs_match_reference(arch):
    rshape = jax.eval_shape(RModel(rconfigs.get_config(arch)).init, jax.random.key(0))
    tshape = Model(tconfigs.get_config(arch)).init(None, device="meta")
    for mesh in MESHES.values():
        for rp, tp in _profiles(mesh):
            assert trules.param_pspecs(tshape, mesh, tp) == \
                _specs(rrules.param_pspecs(rshape, mesh, rp))


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_batch_and_cache_pspecs_match_reference(arch):
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    for kv in ("", "int8"):
        if kv:
            rcfg = dataclasses.replace(rcfg, kv_cache_dtype=kv)
            tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
        for name, shape in tconfigs.SHAPES.items():
            rs = rconfigs.input_specs(rcfg, rconfigs.SHAPES[name])
            ts = tconfigs.input_specs(tcfg, shape)
            for mesh in MESHES.values():
                for rp, tp in _profiles(mesh):
                    if shape.kind == "decode":
                        got = trules.cache_pspecs(ts["cache"], tcfg, tp, mesh)
                        want = rrules.cache_pspecs(rs["cache"], rcfg, rp, mesh)
                        assert got == _specs(want), (name, kv)
                        assert trules.batch_pspecs({"tokens": ts["tokens"]}, tp, mesh) == \
                            _specs(rrules.batch_pspecs({"tokens": rs["tokens"]}, rp, mesh))
                    else:
                        assert trules.batch_pspecs(ts, tp, mesh) == \
                            _specs(rrules.batch_pspecs(rs, rp, mesh)), name


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_default_profile_matches_reference(arch):
    for mesh in MESHES.values():
        want = rprofile(rconfigs.get_config(arch), mesh)
        got = tprofile(tconfigs.get_config(arch), mesh)
        assert (got.tp_axis, tuple(got.dp_axes), got.fsdp) == \
            (want.tp_axis, tuple(want.dp_axes), want.fsdp)


def test_maybe_shard_matches_reference():
    mesh = MESHES["multi_pod"]
    for dim in (1, 2, 16, 36, 48, 50280, 151936):
        for axes in (None, "model", ("data",), ("pod", "data"), ("pod", "data", "model")):
            want = rrules.maybe_shard(dim, axes, mesh)
            # a 1-tuple of axes is its name once in a PartitionSpec
            assert trules.maybe_shard(dim, axes, mesh) == tuple(P(want))[0]


CHILD = r"""
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.training.sharding_rules import distribute, placements
out = {}
for multi, rank in ((False, 37), (True, 300)):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    spec = (("pod", "data") if multi else "data", "model")
    pl = placements(spec, mesh)
    x = torch.arange(64 * 32).reshape(64, 32)
    local = distribute(x, mesh, pl).to_local()
    out[str(multi)] = {"pl": [str(p) for p in pl], "coord": mesh.get_coordinate(),
                       "local": local.tolist()}
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_meshes():
    """Each production mesh under the fake group at one rank, in one child
    process (the fake group is joined only there)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("multi", [False, True])
def test_placements_cut_the_reference_slices(fake_meshes, multi):
    """Shard(d) on every mesh dim a spec names: DTensor's mesh-order split
    gives each rank the slice JAX's major-to-minor order gives it."""
    got = fake_meshes[str(multi)]
    coord = got["coord"]
    if multi:
        assert got["pl"] == ["S(0)", "S(0)", "S(1)"]
        row_block = coord[0] * 16 + coord[1]  # ("pod", "data"), pod major
        rows, cols = 64 // 32, 32 // 16
    else:
        assert got["pl"] == ["S(0)", "S(1)"]
        row_block = coord[0]
        rows, cols = 64 // 16, 32 // 16
    import numpy as np

    full = np.arange(64 * 32).reshape(64, 32)
    want = full[row_block * rows:(row_block + 1) * rows, coord[-1] * cols:(coord[-1] + 1) * cols]
    assert np.array_equal(np.asarray(got["local"]), want)
    assert coord != [0] * len(coord)  # a rank away from the origin


def test_placements_refuse_axes_out_of_mesh_order():
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    with pytest.raises(ValueError, match="mesh's order"):
        trules.placements((("data", "pod"), None), Mesh())
