"""Port parity: the vectorised unfused batched oracle (`core.batched`) and
the batched plain oracle with a gamma per lane (`kernels.ref`,
`kernels.ops`).

Three lanes of one shape, two families, buckets of widths 1, 8 and 64
(wide rows included) with repeated idx, padded slots and fully padded rows,
each lane's slabs drawn from its own numpy seed.

  * `BatchedObjective.calculate` (unfused) and `power_iteration`: every
    field of every lane bitwise the lane's solo `MatchingObjective` call on
    the CPU, for fp32, bf16 and int8 storage and for a formulation with
    another feasible set (capacity-cap's box-cut projection).
  * The same against the reference's vmapped `MatchingObjective.calculate`
    at the oracle's tolerances (tests/test_torch_oracle.py: 1e-6 rel-L2 on
    g and grad, atol 3e-5 on x), and its vmapped power iteration at rtol
    1e-5 (the port drawing the reference's start vector).
  * `dual_oracle_batched_ref` with a [B] gamma: lane b bitwise the solo
    plain call at gamma_b; the CPU route of the batched oracle entry and of
    the batched PDHG prox step the same, per lane.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core.objective import MatchingObjective as JaxObjective
from repro.instances.buckets import Bucket as JaxBucket
from repro.instances.buckets import BucketedInstance as JaxInstance
from repro_torch import convert
from repro_torch.core import objective as tobj
from repro_torch.core.batched import BatchedObjective, lane_instance, stack_lanes
from repro_torch.core.objective import MatchingObjective
from repro_torch.formulation import scenario_formulation
from repro_torch.instances import convert_bucket
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

B, M, J = 3, 2, 12
SHAPES = [(40, 1), (30, 8), (6, 64)]  # (rows, width)


def _lane_reference(seed: int) -> JaxInstance:
    rng = np.random.default_rng(seed)
    buckets = []
    for n, L in SHAPES:
        idx = rng.integers(0, J, size=(n, L)).astype(np.int32)
        mask = (rng.random((n, L)) < 0.8).astype(np.float32)
        mask[-1] = 0.0  # a fully padded row
        idx = idx * mask.astype(np.int32)
        buckets.append(JaxBucket(
            idx=jnp.asarray(idx),
            coeff=jnp.asarray(rng.random((M, n, L)).astype(np.float32) * mask),
            cost=jnp.asarray(rng.normal(size=(n, L)).astype(np.float32) * mask),
            mask=jnp.asarray(mask), length=L))
    rhs = rng.uniform(1.0, 4.0, M * J).astype(np.float32)
    return JaxInstance(buckets=tuple(buckets), rhs=jnp.asarray(rhs),
                       num_sources=sum(n for n, _ in SHAPES), num_destinations=J,
                       num_families=M)


LANES_J = [_lane_reference(30 + b) for b in range(B)]
STACKED_J = jax.tree.map(lambda *xs: jnp.stack(xs), *LANES_J)
STACKED = convert.stacked_from_reference(LANES_J, "cpu")
LAM = torch.from_numpy(np.random.default_rng(7).random((B, M * J)).astype(np.float32))
GAMMA = 0.05


def _stacked(dtype="float32", formulation=None):
    lanes = [lane_instance(STACKED, b) for b in range(B)]
    lanes = [dataclasses.replace(i, buckets=tuple(convert_bucket(bk, dtype) for bk in i.buckets),
                                 formulation=formulation)
             for i in lanes]
    return stack_lanes(lanes)


def _assert_eval_bitwise(ev, solo, b):
    for field in ("g", "grad", "ax", "primal_linear", "primal_ridge"):
        assert torch.equal(getattr(ev, field)[b], torch.as_tensor(getattr(solo, field))), field
    assert all(torch.equal(x[b], s) for x, s in zip(ev.x_slabs, solo.x_slabs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_unfused_calculate_lanes_are_solo_calls(dtype):
    stacked = _stacked(dtype)
    ev = BatchedObjective(stacked).calculate(LAM, GAMMA)
    assert tuple(ev.g.shape) == (B,) and tuple(ev.grad.shape) == (B, M * J)
    for b in range(B):
        _assert_eval_bitwise(ev, MatchingObjective(lane_instance(stacked, b)).calculate(
            LAM[b], GAMMA), b)


def test_unfused_calculate_formulation_lanes_are_solo_calls():
    """A formulation with the box-cut feasible set and non-unit term
    scales: the lanes share it, and each stays its solo call."""
    spec = scenario_formulation("capacity-cap").compile(lane_instance(STACKED, 0)).instance
    stacked = _stacked(formulation=spec.formulation)
    obj = BatchedObjective(stacked)
    assert type(obj._proj(0)).__name__ == "BoxCutProjection"
    ev = obj.calculate(LAM, GAMMA)
    for b in range(B):
        _assert_eval_bitwise(ev, MatchingObjective(lane_instance(stacked, b)).calculate(
            LAM[b], GAMMA), b)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_power_iteration_lanes_are_solo(dtype):
    stacked = _stacked(dtype)
    got = BatchedObjective(stacked).power_iteration(3, iters=20)
    want = [MatchingObjective(lane_instance(stacked, b)).power_iteration(3, iters=20)
            for b in range(B)]
    assert all(torch.equal(got[b], w) for b, w in enumerate(want))
    assert len(set(got.tolist())) == B


def test_unfused_calculate_matches_vmapped_reference():
    want = jax.vmap(lambda inst, lam: JaxObjective(inst).calculate(lam, GAMMA))(
        STACKED_J, jnp.asarray(LAM.numpy()))
    got = BatchedObjective(STACKED).calculate(LAM, GAMMA)
    for b in range(B):
        for name in ("g", "grad"):
            a = getattr(got, name)[b].numpy().astype(np.float64)
            w = np.asarray(getattr(want, name)[b], np.float64)
            assert np.linalg.norm(a - w) <= 1e-6 * max(np.linalg.norm(w), 1e-12), name
        for x, wx in zip(got.x_slabs, want.x_slabs):
            np.testing.assert_allclose(x[b].numpy(), np.asarray(wx[b]), atol=3e-5)


def test_power_iteration_matches_vmapped_reference(monkeypatch):
    def start_vector(n, seed, device):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.key(seed), (n,),
                                                           jnp.float32))).to(device)

    monkeypatch.setattr(tobj, "start_vector", start_vector)
    want = jax.vmap(lambda inst: JaxObjective(inst).power_iteration(
        jax.random.key(3), iters=20))(STACKED_J)
    got = BatchedObjective(STACKED).power_iteration(3, iters=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_batched_ref_takes_a_gamma_per_lane():
    gammas = torch.tensor([0.05, 0.3, 1.7], dtype=torch.float32)
    xs, ax, lin, sq = tref.dual_oracle_batched_ref(STACKED.buckets, LAM, gammas, J)
    via_ops = tops.fused_dual_oracle_batched_call(STACKED.buckets, LAM, gammas,
                                                  num_destinations=J)
    for b in range(B):
        lane = [tref.lane_slab(bk, b) for bk in STACKED.buckets]
        sx, sax, slin, ssq = tref.dual_oracle_call_ref(lane, LAM[b], float(gammas[b]), J)
        assert all(torch.equal(x[b], s) for x, s in zip(xs, sx))
        assert torch.equal(ax[b], sax) and torch.equal(lin[b], slin) and torch.equal(sq[b], ssq)
        assert all(torch.equal(x[b], s) for x, s in zip(via_ops[0], sx))
        assert torch.equal(via_ops[1][b], sax)
    # a shared float is every lane's gamma
    shared = tref.dual_oracle_batched_ref(STACKED.buckets, LAM, 0.3, J)
    assert torch.equal(shared[1][1], ax[1]) and not torch.equal(shared[1][0], ax[0])


def test_batched_pdhg_step_lanes_are_solo_steps():
    """The batched prox step with tau per lane: lane b bitwise the solo
    whole-call step at tau_b (cost_eff = c - x * fp32(1/tau_b), rounded
    twice)."""
    rng = np.random.default_rng(11)
    taus = [0.37, 0.05, 1.3]
    xs = [torch.from_numpy(rng.random(bk.cost.shape).astype(np.float32)) * bk.mask
          for bk in STACKED.buckets]
    costs = [bk.cost for bk in STACKED.buckets]
    step = tops.plan_pdhg_step_batched(STACKED.buckets, costs, taus, num_destinations=J)
    assert step.launches_per_call == 0 and step.plan is None  # the CPU has no plan
    got_xs, got_ax = tops.fused_pdhg_step_batched_call(step, xs, LAM)
    for b, tau in enumerate(taus):
        lane = lane_instance(STACKED, b)
        solo = tops.plan_pdhg_step(lane.buckets, [bk.cost for bk in lane.buckets],
                                   num_destinations=J)
        sx, sax = tops.fused_pdhg_step_call(solo, [x[b] for x in xs], LAM[b], tau)
        assert all(torch.equal(x[b], s) for x, s in zip(got_xs, sx))
        assert torch.equal(got_ax[b], sax)
        assert all(torch.equal(s.cost[b], t.cost) for s, t in zip(step.slabs, solo.slabs))
