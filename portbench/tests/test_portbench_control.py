"""The comparison's control and its faults, at a size the CPU holds.

The control is the program one precision below the configuration's (bfloat16
slabs for float32): it has to come out not correct, where the program at the
configuration's precision comes out correct.  Each fault that a cell can have
is planted under the timed path, and the run has to come out not correct.
(The exchange between chips is no fault of these one-chip cells.)"""
from __future__ import annotations

import dataclasses

import pytest

from portbench_tiny import tiny

SEED = 424242


def verdict(workload: str, control: bool = False) -> dict:
    from portbench import run

    return run.execute(tiny(workload), SEED, 0.2, False, device="cpu", control=control)


@pytest.mark.parametrize("workload", ["s3.5m-solve", "s1m-cadence"])
def test_control_is_not_correct(workload):
    sound, control = verdict(workload), verdict(workload, control=True)
    assert sound["correct"] is True
    assert control["correct"] is False
    over = [k for k, c in control["checks"].items() if c["value"] > c["limit"]]
    assert over, control["checks"]


def _state_unchanged(monkeypatch):
    from repro_torch.core import maximizer

    body = maximizer._agd_body

    def stuck(*a, **k):
        step = body(*a, **k)
        return lambda carry: (carry, step(carry)[1])

    monkeypatch.setattr(maximizer, "_agd_body", stuck)


def _half_left_out(monkeypatch):
    """The oracle sees the first half of each bucket's rows only."""
    from repro_torch.kernels import ops

    call = ops.fused_dual_oracle_call

    def half(buckets, *a, **k):
        cut = []
        for b in buckets:
            mask = b.mask.clone()
            mask[mask.shape[0] // 2:] = 0
            cut.append(dataclasses.replace(b, mask=mask))
        return call(cut, *a, **k)

    monkeypatch.setattr(ops, "fused_dual_oracle_call", half)


def _answer_altered(monkeypatch):
    """The oracle's primal comes back altered in one slot."""
    from repro_torch.kernels import ops

    call = ops.fused_dual_oracle_call

    def altered(*a, **k):
        x, ax, lin, sq = call(*a, **k)
        x0 = x[0].clone()
        x0.view(-1)[0] += 0.25
        return (x0, *x[1:]), ax, lin, sq

    monkeypatch.setattr(ops, "fused_dual_oracle_call", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered])
def test_solve_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert verdict("s3.5m-solve")["correct"] is False


def _replay_unchanged(monkeypatch):
    """The device copy keeps its state: the scatter plans are not replayed."""
    from repro_torch.service import session

    monkeypatch.setattr(session, "apply_scatter_plan", lambda inst, plan: inst)


def _half_delta_left_out(monkeypatch):
    """Half of each delta's value updates never reach the slabs."""
    from repro_torch.instances import deltas

    apply = deltas.DeltaIngestor.apply

    def half(self, d):
        k = d.update_src.size // 2
        return apply(self, dataclasses.replace(
            d, update_src=d.update_src[:k], update_dst=d.update_dst[:k],
            update_values=d.update_values[:k]))

    monkeypatch.setattr(deltas.DeltaIngestor, "apply", half)


def _objective_altered(monkeypatch):
    """Each solve's dual objective comes back altered."""
    from repro_torch.service import scheduler

    convert = scheduler.to_solve_result

    def altered(raw):
        res = convert(raw)
        return res._replace(g=res.g * 1.001)

    monkeypatch.setattr(scheduler, "to_solve_result", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _replay_unchanged, _half_delta_left_out,
                                   _objective_altered])
def test_cadence_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert verdict("s1m-cadence")["correct"] is False
