"""The column-sharded solve of the port over gloo, in spawned processes.

Mirrors tests/test_distributed.py on the same instance (200 sources x 16
destinations, m = 2, every bucket padded to a multiple of 4 rows) with 1, 2
and 4 processes on the CPU: the g trace of every communication mode against
the single-process port within 1e-3 (0.1 for the bf16 wire with error
feedback); with early stopping identical `iters_used` and lam within 1e-6
rel-L2; the same with the fused primal kernel and the fused oracle; a
2-process solve against the JAX package's single-device Maximizer; the
CLI's `--shards 2` against `--shards 1`; and the sharded PDHG solve over 2
processes against the single-process PDHG solve (g rtol 1e-3, the
reference's bound, tests/test_engines.py:342), dense and bucketed.

The processes join through a file in the test's tmp_path (no TCP port),
run one thread each, and import no JAX: the reference's start vector
reaches them as a numpy array.  This module imports JAX only inside the one
test that compares with it, because the spawned processes import it.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core import (
    DistConfig, DistributedMaximizer, Maximizer, MaximizerConfig,
    MatchingObjective, normalize_rows, shard_instance,
)
from repro_torch.core import objective as tobj
from repro_torch.core.sharding import gather_rows
from repro_torch.engines.pdhg import PDHGEngineConfig, pdhg_raw_solve, solve_pdhg_sharded
from repro_torch.instances import (
    MatchingInstanceSpec, bucketize, generate_matching_instance,
)
from repro_torch.launch import dist as launch_dist
from repro_torch.launch import solve as tsolve

SPEC = dict(num_sources=200, num_destinations=16, avg_degree=4.0,
            num_families=2, seed=3)
PARITY_CFG = dict(iters_per_stage=80)
EARLY_CFG = dict(gammas=(10.0, 1.0), iters_per_stage=600, adaptive_restart=False,
                 tol_viol=1e-5, check_every=50)
FUSED_CFG = dict(iters_per_stage=80, adaptive_restart=False)
MODES = [("psum", "none"), ("rank0", "none"), ("psum", "bf16_ef")]


def _instance():
    packed = bucketize(generate_matching_instance(MatchingInstanceSpec(**SPEC)),
                       shard_multiple=4, device="cpu")
    return normalize_rows(packed)[0]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _trace_dev(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / (np.abs(want) + 1e-9)))


def _result(res):
    return {"lam": res.lam.numpy(), "g": float(res.g),
            "trace": res.stats[-1].g.numpy(), "iters_used": res.iters_used}


# -- what each spawned process runs (rank 0 returns the results) -------------


def _solve_modes(cfg, runs, start=None):
    """One DistributedMaximizer solve per (DistConfig kwargs) in `runs`."""
    if start is not None:
        tobj.start_vector = lambda n, seed, device: torch.from_numpy(start).to(device)
    inst = _instance()
    return {name: _result(DistributedMaximizer(inst, MaximizerConfig(**cfg),
                                               DistConfig(**kw)).solve())
            for name, kw in runs.items()}


PDHG_SPEC = dict(num_sources=60, num_destinations=10, avg_degree=4.0, seed=5)
PDHG_CFG = dict(gammas=(0.01,), iters_per_stage=4000, tol_grad=1e-4, check_every=50)


def _pdhg_instance():
    return bucketize(generate_matching_instance(MatchingInstanceSpec(**PDHG_SPEC)),
                     shard_multiple=2, device="cpu")


def _pdhg_sharded(dense, fused):
    res = solve_pdhg_sharded(_pdhg_instance(), MaximizerConfig(**PDHG_CFG),
                             DistConfig(fused_oracle=fused),
                             PDHGEngineConfig(restart="adaptive", dense=dense))
    return {"g": float(res.g), "iters": res.iters_used, "restarts": res.restarts,
            "lam": res.lam.numpy()}


def _cli(argv):
    r = tsolve.run(tsolve.build_parser().parse_args(argv))
    return {"g": float(r.result.g), "value": r.value, "shards": r.shards,
            "iters": r.total_iters}


def _worker(rank, world, init_file, out_file, fn, args):
    torch.set_num_threads(1)
    launch_dist.setup("cpu", init_method=f"file://{init_file}", rank=rank,
                      world_size=world)
    out = fn(*args)
    if rank == 0:
        torch.save(out, out_file)
    launch_dist.teardown()


def _spawn(tmp_path, world, fn, *args):
    out_file = tmp_path / f"out-{world}.pt"
    mp.spawn(_worker, args=(world, str(tmp_path / f"pg-{world}"), str(out_file), fn, args),
             nprocs=world, join=True)
    return torch.load(out_file, weights_only=False)


# -- tests ----------------------------------------------------------------------


def test_shard_instance_splits_rows_contiguously():
    inst = _instance()
    parts = [shard_instance(inst, r, 4) for r in range(4)]
    for k, b in enumerate(inst.buckets):
        for field in ("idx", "cost", "mask"):
            whole = torch.cat([getattr(p.buckets[k], field) for p in parts])
            assert torch.equal(whole, getattr(b, field))
        assert torch.equal(torch.cat([p.buckets[k].coeff for p in parts], dim=1), b.coeff)
        assert all(p.buckets[k].coeff.is_contiguous() for p in parts)
    assert all(torch.equal(p.rhs, inst.rhs) for p in parts)
    with pytest.raises(ValueError, match="shard_multiple"):
        shard_instance(inst, 0, 3)


def test_dist_config_refuses_unknown_options():
    for kw in (dict(comm_mode="ring"), dict(compress="fp8")):
        with pytest.raises(ValueError, match="choose from"):
            DistConfig(**kw)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("mode,compress", MODES)
def test_sharded_parity_modes(tmp_path, world, mode, compress):
    ref = Maximizer(MatchingObjective(_instance()), MaximizerConfig(**PARITY_CFG)).solve()
    runs = {"run": dict(comm_mode=mode, compress=compress)}
    got = _spawn(tmp_path, world, _solve_modes, PARITY_CFG, runs)["run"]
    # exact-arithmetic modes track to fp32 reduction noise; the compressed
    # wire drifts but stays in the same basin (reference bounds)
    bound = 0.1 if compress == "bf16_ef" else 1e-3
    assert _trace_dev(got["trace"], ref.stats[-1].g.numpy()) < bound


@pytest.mark.parametrize("world", [1, 2, 4])
def test_early_stop_parity_across_processes(tmp_path, world):
    cfg = MaximizerConfig(**EARLY_CFG)
    ref = Maximizer(MatchingObjective(_instance()), cfg).solve()
    assert ref.total_iters_used < cfg.total_iter_budget  # the criterion fired
    got = _spawn(tmp_path, world, _solve_modes, EARLY_CFG, {"psum": {}})["psum"]
    assert got["iters_used"] == ref.iters_used
    assert _rel(got["lam"], ref.lam.numpy()) < 1e-6


@pytest.mark.parametrize("world", [1, 2, 4])
def test_fused_sharded_parity(tmp_path, world):
    ref = Maximizer(MatchingObjective(_instance()), MaximizerConfig(**FUSED_CFG)).solve()
    runs = {"fused_kernel": dict(fused_kernel=True), "fused_oracle": dict(fused_oracle=True)}
    got = _spawn(tmp_path, world, _solve_modes, FUSED_CFG, runs)
    for name in runs:
        assert _rel(got[name]["lam"], ref.lam.numpy()) < 1e-6, name
        assert _trace_dev(got[name]["trace"], ref.stats[-1].g.numpy()) < 1e-3, name


def test_two_processes_match_the_reference_maximizer(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import Maximizer as JaxMaximizer
    from repro.core import MaximizerConfig as JaxConfig
    from repro.core.objective import MatchingObjective as JaxObjective
    from repro.core.objective import normalize_rows as jax_normalize_rows
    from repro.instances import MatchingInstanceSpec as JaxSpec
    from repro.instances import bucketize as jax_bucketize
    from repro.instances import generate_matching_instance as jax_generate

    pj, _ = jax_normalize_rows(jax_bucketize(jax_generate(JaxSpec(**SPEC)),
                                             shard_multiple=4))
    # adaptive restart off, as in the reference's lam comparisons: the
    # restart test g < g_prev flips on fp32 reduction-order noise
    want = JaxMaximizer(JaxObjective(pj), JaxConfig(**FUSED_CFG)).solve()
    start = np.array(jax.random.normal(jax.random.key(0), (pj.dual_dim,), jnp.float32))
    got = _spawn(tmp_path, 2, _solve_modes, FUSED_CFG, {"psum": {}}, start)["psum"]
    # the reference's sharded-vs-single bound on the trace
    assert _trace_dev(got["trace"], np.asarray(want.stats[-1].g)) < 1e-3
    assert _rel(got["lam"], np.asarray(want.lam)) < 1e-5


def test_cli_shards_match_one_process(tmp_path):
    argv = ["--sources", "300", "--destinations", "20", "--iters-per-stage", "10",
            "--fused-kernel", "--device", "cpu"]
    one = _cli(argv)
    two = _spawn(tmp_path, 2, _cli, argv + ["--shards", "2"])
    assert (one["shards"], two["shards"]) == (1, 2)
    assert two["iters"] == one["iters"] == 60
    assert abs(two["g"] - one["g"]) <= 1e-5 * abs(one["g"])
    assert abs(two["value"] - one["value"]) <= 1e-4 * abs(one["value"])


def test_world_of_one_equals_the_single_device_solve(tmp_path):
    """At world size 1 the all-reduce is the identity: the sharded solve is
    the single-device one, bit for bit, on the CPU."""
    cfg = dict(iters_per_stage=20, tol_viol=1e-4, check_every=10)
    ref = Maximizer(MatchingObjective(_instance(), fused_kernel=True),
                    MaximizerConfig(**cfg)).solve()
    got = _spawn(tmp_path, 1, _solve_modes, cfg, {"k": dict(fused_kernel=True)})["k"]
    assert np.array_equal(got["lam"], ref.lam.numpy())
    assert got["g"] == float(ref.g)
    assert got["iters_used"] == ref.iters_used


@pytest.mark.parametrize("dense,fused", [("auto", False), ("off", True)])
def test_pdhg_sharded_matches_single_process(tmp_path, dense, fused):
    """The sharded PDHG solve in 2 processes against the single-process solve
    (fused prox step, as the reference's test has it); the 2 shards take the
    dense path under "auto" and the fused all-reduced A x under "off"."""
    inst = _pdhg_instance()
    single = pdhg_raw_solve(inst, torch.zeros(inst.dual_dim), MaximizerConfig(**PDHG_CFG),
                            normalize=False, fused_oracle=True,
                            pcfg=PDHGEngineConfig(restart="adaptive"))
    got = _spawn(tmp_path, 2, _pdhg_sharded, dense, fused)
    np.testing.assert_allclose(got["g"], float(single.g), rtol=1e-3)
    assert got["restarts"] > 0
    # without a process group the sharded entry is the single-process solve
    alone = solve_pdhg_sharded(_pdhg_instance(), MaximizerConfig(**PDHG_CFG),
                               pcfg=PDHGEngineConfig(restart="adaptive"))
    assert alone.iters_used == (int(single.iters[0]),)


def test_distributed_maximizer_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        DistributedMaximizer(_instance())


def test_gather_primal_reassembles_rows(tmp_path):
    got = _spawn(tmp_path, 2, _gather_round_trip)
    inst = _instance()
    assert [tuple(x.shape) for x in got] == [tuple(b.cost.shape) for b in inst.buckets]
    for x, b in zip(got, inst.buckets):
        assert torch.equal(x, b.cost)


def _gather_round_trip():
    dm = DistributedMaximizer(_instance())
    return gather_rows([b.cost for b in dm.local.buckets])
