"""Card-only tests of the port: the three hand-written kernels (the dual
oracle, the primal step and the simplex projection) against their plain
PyTorch versions, and small solves through them against the same solves on
the CPU.

Every test is marked `cuda` and skips (in a fixture, at run time) when
`torch.cuda.is_available()` is False.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: x atol 3e-5 (fp32, int8) / 2e-2 (bf16) as tests/test_kernels.py;
hist, c'x and ||x||^2 atol 3e-5 + rtol 1e-5 as tests/test_dual_oracle.py.
The primal-step kernel calls the oracle's own __device__ functions, so its x
is held bitwise equal to the oracle's.
No JAX here: the machine with the card need not have it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Maximizer, MaximizerConfig, MatchingObjective
from repro_torch.instances import (
    MatchingInstanceSpec, bucketize, generate_matching_instance,
)
from repro_torch.instances.buckets import Bucket, convert_bucket
from repro_torch.core.projections import UnitSimplexProjection
from repro_torch.kernels import dual_oracle as kdo
from repro_torch.kernels import dual_primal as kdp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import simplex_proj as ksp

pytestmark = pytest.mark.cuda

X_ATOL = {"float32": 3e-5, "bfloat16": 2e-2, "int8": 3e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _bucket(seed, n, L, m, J, dtype, device, padded_rows=5):
    rng = np.random.default_rng(seed)
    mask = (rng.random((n, L)) < 0.8).astype(np.float32)
    mask[:padded_rows] = 0.0
    idx = (rng.integers(0, J, size=(n, L)) * mask).astype(np.int32)
    coeff = (rng.random((m, n, L)) * mask[None]).astype(np.float32)
    cost = (rng.normal(size=(n, L)) * mask).astype(np.float32)
    b = Bucket(idx=torch.from_numpy(idx), coeff=torch.from_numpy(coeff),
               cost=torch.from_numpy(cost), mask=torch.from_numpy(mask), length=L)
    lam = torch.from_numpy(rng.random(m * J).astype(np.float32)).to(device)
    return convert_bucket(b, dtype).to(device), lam


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L,m", [(1, 1), (8, 1), (32, 3), (64, 3), (512, 1)])
@pytest.mark.parametrize("inequality", [True, False])
def test_kernel_matches_plain_version(cuda, dtype, L, m, inequality):
    J, n = 64, 300 if L <= 64 else 20
    b, lam = _bucket(L * 10 + m, n, L, m, J, dtype, cuda)
    for gamma in (0.01, 1.0, 100.0):
        args = (b.idx, b.coeff, b.cost, b.mask, lam, gamma)
        kw = dict(radius=1.0, inequality=inequality,
                  coeff_scale=b.coeff_scale, cost_scale=b.cost_scale)
        x, hist, lin, sq = kops.fused_dual_oracle(*args, num_destinations=J, **kw)
        wx, whist, wlin, wsq = kref.dual_oracle_ref(*args, J, **kw)
        assert x.dtype == wx.dtype
        np.testing.assert_allclose(
            x.float().cpu().numpy(), wx.float().cpu().numpy(), atol=X_ATOL[dtype]
        )
        for a, w in ((hist, whist), (lin, wlin), (sq, wsq)):
            np.testing.assert_allclose(
                a.cpu().numpy(), w.cpu().numpy(), atol=3e-5, rtol=1e-5
            )
        assert float(x[:5].float().abs().max()) == 0.0


def test_kernel_is_bitwise_deterministic(cuda):
    b, lam = _bucket(1, 5000, 16, 2, 64, "float32", cuda)
    args = (b.idx, b.coeff, b.cost, b.mask, lam, 0.5)
    first = kdo.dual_oracle(*args, num_destinations=64)
    second = kdo.dual_oracle(*args, num_destinations=64)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_kernel_refuses_what_it_cannot_take(cuda):
    b, lam = _bucket(2, 50, 8, 1, 64, "float32", cuda)
    args = (b.idx, b.coeff, b.cost, b.mask, lam, 1.0)
    with pytest.raises(ValueError, match="dtype"):
        kdo.dual_oracle(b.idx, b.coeff.half(), b.cost.half(), b.mask.half(),
                        lam, 1.0, num_destinations=64)
    with pytest.raises(ValueError, match="capacity"):
        big = torch.zeros(60_000, device=cuda)
        kops.fused_dual_oracle(*args[:4], big, 1.0, num_destinations=60_000)
    with pytest.raises(ValueError, match="contiguous"):
        kdo.dual_oracle(b.idx.t().contiguous().t(), *args[1:], num_destinations=64)


def test_fused_solve_launches_kernel_and_matches_cpu(cuda):
    spec = MatchingInstanceSpec(num_sources=3000, num_destinations=60,
                                avg_degree=6.0, num_families=2, seed=4)
    edges = generate_matching_instance(spec)
    cfg = MaximizerConfig(iters_per_stage=20)
    kdo.launches = 0
    kops.width_routed = 0
    packed = bucketize(edges, device=cuda)
    on_card = Maximizer(MatchingObjective(packed, fused_oracle=True), cfg).solve()
    assert kdo.launches == len(packed.buckets) * (cfg.total_iters + 1)
    assert kops.width_routed == 0
    on_cpu = Maximizer(
        MatchingObjective(packed.to("cpu"), fused_oracle=True), cfg
    ).solve()
    rel = float(torch.linalg.vector_norm(on_card.lam.cpu() - on_cpu.lam)
                / torch.linalg.vector_norm(on_cpu.lam))
    assert rel <= 1e-4
    assert abs(float(on_card.g) - float(on_cpu.g)) <= 1e-5 * abs(float(on_cpu.g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L,m", [(1, 1), (8, 2), (32, 3), (64, 3), (8192, 1)])
@pytest.mark.parametrize("inequality", [True, False])
def test_primal_kernel_matches_plain_version_and_oracle(cuda, dtype, L, m, inequality):
    J, n = 64, 300 if L <= 64 else 7
    b, lam = _bucket(L * 10 + m + 1, n, L, m, J, dtype, cuda)
    for gamma in (0.01, 1.0, 100.0):
        args = (b.idx, b.coeff, b.cost, b.mask, lam, gamma)
        kw = dict(radius=1.0, inequality=inequality,
                  coeff_scale=b.coeff_scale, cost_scale=b.cost_scale)
        x = kops.fused_dual_primal(*args, num_destinations=J, **kw)
        want = kref.dual_primal_ref(*args, J, **kw)
        assert x.dtype == want.dtype
        np.testing.assert_allclose(
            x.float().cpu().numpy(), want.float().cpu().numpy(), atol=X_ATOL[dtype]
        )
        assert float(x[:5].float().abs().max()) == 0.0
        oracle_x = kdo.dual_oracle(*args, num_destinations=J, **kw)[0]
        assert torch.equal(x, oracle_x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L,n,m,J", [(16, 3000, 1, 70_000), (256, 37, 3, 20_000)])
def test_primal_kernel_reads_lam_through_l2(cuda, dtype, L, n, m, J):
    """m*J past shared memory: the plan reads lam through L1/L2."""
    props = torch.cuda.get_device_properties(cuda)
    assert not kdp.plan_launch(n, L, m, J, props.multi_processor_count).lam_in_smem
    b, lam = _bucket(L + m, n, L, m, J, dtype, cuda)
    for gamma, inequality in ((0.01, True), (1.0, False), (100.0, True)):
        args = (b.idx, b.coeff, b.cost, b.mask, lam, gamma)
        kw = dict(radius=2.5, inequality=inequality,
                  coeff_scale=b.coeff_scale, cost_scale=b.cost_scale)
        x = kops.fused_dual_primal(*args, num_destinations=J, **kw)
        want = kref.dual_primal_ref(*args, J, **kw)
        assert x.dtype == want.dtype
        np.testing.assert_allclose(
            x.float().cpu().numpy(), want.float().cpu().numpy(), atol=X_ATOL[dtype]
        )
        assert float(x[:5].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 4, 32, 64, 1024, 8192])
@pytest.mark.parametrize("inequality", [True, False])
@pytest.mark.parametrize("radius", [1.0, 2.5])
def test_simplex_kernel_matches_plain_version(cuda, dtype, L, inequality, radius):
    rng = np.random.default_rng(L)
    n = 500 if L <= 64 else 9
    v = torch.from_numpy((rng.normal(size=(n, L)) * 2).astype(np.float32))
    mask = torch.from_numpy((rng.random((n, L)) < 0.7).astype(np.float32))
    mask[:3] = 0.0
    v, mask = v.to(cuda, dtype), mask.to(cuda, dtype)
    got = kops.fused_project_simplex(v, mask, radius=radius, inequality=inequality)
    want = kref.simplex_ref(v, mask, radius, inequality=inequality)
    assert got.dtype == dtype
    atol = 3e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol)
    assert float(got[:3].float().abs().max()) == 0.0


def test_primal_and_simplex_kernels_refuse_what_they_cannot_take(cuda):
    b, lam = _bucket(3, 50, 8, 1, 64, "float32", cuda)
    with pytest.raises(ValueError, match="dtype"):
        kdp.dual_primal(b.idx, b.coeff.half(), b.cost.half(), b.mask.half(),
                        lam, 1.0, num_destinations=64)
    with pytest.raises(ValueError, match="contiguous"):
        kdp.dual_primal(b.idx.t().contiguous().t(), b.coeff, b.cost, b.mask, lam,
                        1.0, num_destinations=64)
    with pytest.raises(ValueError, match="dtype"):
        ksp.simplex_proj(b.cost.half(), b.mask.half())
    with pytest.raises(ValueError, match="share one dtype"):
        ksp.simplex_proj(b.cost, b.mask.bfloat16())
    with pytest.raises(ValueError, match="power of two"):
        ksp.simplex_proj(b.cost[:, :6].contiguous(), b.mask[:, :6].contiguous())


def _small_solve(device, **objective_kw):
    spec = MatchingInstanceSpec(num_sources=3000, num_destinations=60,
                                avg_degree=6.0, num_families=2, seed=4)
    packed = bucketize(generate_matching_instance(spec), device=device)
    obj = MatchingObjective(packed, **objective_kw)
    return Maximizer(obj, MaximizerConfig(iters_per_stage=20)).solve(), len(packed.buckets)


def _rel_lam(a, b):
    return float(torch.linalg.vector_norm(a.lam.cpu() - b.lam)
                 / torch.linalg.vector_norm(b.lam))


def test_fused_kernel_solve_launches_kernel_and_matches_cpu(cuda):
    kdp.launches = 0
    kops.width_routed = 0
    on_card, buckets = _small_solve(cuda, fused_kernel=True)
    assert kdp.launches == buckets * (MaximizerConfig(iters_per_stage=20).total_iters + 1)
    assert kops.width_routed == 0
    on_cpu, _ = _small_solve("cpu", fused_kernel=True)
    assert _rel_lam(on_card, on_cpu) <= 1e-6


def test_simplex_kernel_solve_launches_kernel_and_matches_cpu(cuda):
    ksp.launches = 0
    proj = UnitSimplexProjection(use_kernel=True)
    on_card, buckets = _small_solve(cuda, projection=proj)
    assert ksp.launches == buckets * (MaximizerConfig(iters_per_stage=20).total_iters + 1)
    on_cpu, _ = _small_solve("cpu", projection=proj)
    assert _rel_lam(on_card, on_cpu) <= 1e-6
