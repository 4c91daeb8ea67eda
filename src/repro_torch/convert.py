"""Carry the JAX package's state across as the port's tensors.

The functions read any object with the JAX package's `BucketedInstance`
layout (buckets with idx/coeff/cost/mask/length/coeff_scale/cost_scale, rhs,
num_sources/num_destinations/num_families) through `np.asarray` of every
leaf, and return the port's tensors on a given device.  bfloat16 arrays
arrive as numpy arrays of the `bfloat16` extension dtype; they are
reinterpreted bit for bit, so this module needs neither JAX nor ml_dtypes.
The packing bookkeeping of the reference does not travel, so a converted
instance cannot `unpack_primal`.  An attached formulation does travel: its
spec is rebuilt from the port's classes of the same names
(`formulation_from_reference`).  The recurring-solve pieces travel too: an
`InstanceDelta` (host numpy in both packages), a `ScatterPlan` (the port's
holds CPU tensors) and the COO LP of the PDHG baseline.  So do the service's
pieces: a published `DualSnapshot` (its duals, instance and maps) and a
`ServiceConfig`, and the lanes of a batched solve (`stacked_from_reference`:
instances of one shape, or the reference's own stack, as the port's stacked
instance).  Tenant state crosses through the checkpoint format, which
both packages share (`repro_torch.checkpoint`).  The LM substrate's params
and caches travel as trees of numpy leaves (`lm_params_from_reference`,
`lm_cache_from_reference`): the same tree paths, stacked leading layer
dimensions and the `prefix` list kept; so does a training state
(`train_state_from_reference`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import formulation as tform
from repro_torch.core.pdhg import COOLP
from repro_torch.device import resolve_device
from repro_torch.instances.buckets import Bucket, BucketedInstance
from repro_torch.instances.deltas import BucketScatter, InstanceDelta, ScatterPlan

__all__ = [
    "coolp_from_reference",
    "delta_from_reference",
    "formulation_from_reference",
    "instance_from_reference",
    "lam_from_numpy",
    "lm_cache_from_reference",
    "lm_params_from_reference",
    "scatter_plan_from_reference",
    "service_config_from_reference",
    "snapshot_from_reference",
    "stacked_from_reference",
    "tensor_from_numpy",
    "train_state_from_reference",
]


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A copy of array `a` as a tensor on `device` (bfloat16 bit for bit)."""
    dev = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _bucket(b, device) -> Bucket:
    opt = lambda a: None if a is None else tensor_from_numpy(a, device)
    return Bucket(
        idx=tensor_from_numpy(b.idx, device),
        coeff=tensor_from_numpy(b.coeff, device),
        cost=tensor_from_numpy(b.cost, device),
        mask=tensor_from_numpy(b.mask, device),
        length=int(b.length),
        coeff_scale=opt(b.coeff_scale),
        cost_scale=opt(b.cost_scale),
    )


def _feasible_set(s, device) -> tform.FeasibleSet:
    """The port's feasible set of the reference's class name, field for
    field; array-valued fields become tensors on `device`."""
    cls = getattr(tform, type(s).__name__, None)
    if not (isinstance(cls, type) and issubclass(cls, tform.FeasibleSet)):
        raise ValueError(f"no ported feasible set for {type(s).__name__}")
    kw = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        kw[f.name] = v if np.ndim(v) == 0 else tensor_from_numpy(v, device)
    return cls(**kw)


def formulation_from_reference(spec, device="cuda") -> tform.FormulationSpec:
    """The port's FormulationSpec equal to the reference's `spec`: the same
    feasible sets (rebuilt from the port's catalog), term scales and name."""
    return tform.FormulationSpec(
        feasible=tuple(_feasible_set(s, device) for s in spec.feasible),
        cost_scale=float(spec.cost_scale),
        ridge_weight=float(spec.ridge_weight),
        name=str(spec.name),
    )


def instance_from_reference(inst, device="cuda") -> BucketedInstance:
    """The port's BucketedInstance holding the same slabs (and the same
    formulation, when one is attached) as `inst`."""
    spec = getattr(inst, "formulation", None)
    return BucketedInstance(
        buckets=tuple(_bucket(b, device) for b in inst.buckets),
        rhs=tensor_from_numpy(inst.rhs, device),
        num_sources=int(inst.num_sources),
        num_destinations=int(inst.num_destinations),
        num_families=int(inst.num_families),
        formulation=None if spec is None else formulation_from_reference(spec, device),
    )


def lam_from_numpy(lam, device="cuda") -> torch.Tensor:
    """Dual vector [m*J] as an fp32 tensor on `device`."""
    return tensor_from_numpy(np.asarray(lam, dtype=np.float32), device)


def delta_from_reference(delta) -> InstanceDelta:
    """The port's InstanceDelta holding the same arrays as `delta`."""
    return InstanceDelta(**{
        f.name: getattr(delta, f.name) for f in dataclasses.fields(InstanceDelta)
    })


def scatter_plan_from_reference(plan) -> ScatterPlan:
    """The port's ScatterPlan (CPU tensors) of the reference's `plan`: the
    same runs and the same cell values, bfloat16 bit for bit."""
    cpu = lambda a: tensor_from_numpy(a, "cpu")
    ops = tuple(
        BucketScatter(
            bucket=int(op.bucket), run_rows=cpu(op.run_rows), run_slots=cpu(op.run_slots),
            run_lengths=cpu(op.run_lengths), idx=cpu(op.idx), cost=cpu(op.cost),
            mask=cpu(op.mask), coeff=cpu(op.coeff),
        )
        for op in plan.ops
    )
    rhs = None if plan.rhs is None else cpu(plan.rhs)
    return ScatterPlan(generation=int(plan.generation), ops=ops, rhs=rhs)


def coolp_from_reference(lp, device="cuda") -> COOLP:
    """The port's COOLP of the reference's (the same entries, in the same
    order; the sorted copies are rebuilt)."""
    t = lambda a: tensor_from_numpy(a, device)
    return COOLP(
        rows=t(lp.rows), cols=t(lp.cols), vals=t(lp.vals), c=t(lp.c), q=t(lp.q),
        u=t(lp.u), num_rows=int(lp.num_rows), num_cols=int(lp.num_cols),
    )


def _config_from_reference(cfg):
    """The port's MaximizerConfig with the reference config's fields (those
    the port has: the reference's `record_every` has no counterpart)."""
    from repro_torch.core.maximizer import MaximizerConfig

    names = {f.name for f in dataclasses.fields(MaximizerConfig)}
    return MaximizerConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                              if f.name in names})


def service_config_from_reference(cfg):
    """The port's ServiceConfig with the reference's knobs, field for field
    (the cold solver config field for field too)."""
    from repro_torch.service.session import ServiceConfig

    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["cold"] = _config_from_reference(cfg.cold)
    return ServiceConfig(**kw)


def snapshot_from_reference(snap, device="cuda"):
    """The port's DualSnapshot holding the reference snapshot's published
    duals, instance (and formulation) and occupancy maps."""
    from repro_torch.serving.duals import DualSnapshot

    dev = resolve_device(device)
    lam_eff = lam_from_numpy(snap.lam_eff, dev)
    instance = instance_from_reference(snap.instance, dev)
    ready = None
    if dev.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
    return DualSnapshot(
        tenant=str(snap.tenant), generation=int(snap.generation),
        cadence=int(snap.cadence), gamma=float(snap.gamma), lam_eff=lam_eff,
        instance=instance,
        bucket_of=np.asarray(snap.bucket_of, np.int64).copy(),
        row_of=np.asarray(snap.row_of, np.int64).copy(),
        deg=np.asarray(snap.deg, np.int64).copy(), ready=ready,
    )


def stacked_from_reference(insts, device="cuda") -> BucketedInstance:
    """The port's stacked instance (a leading lane dimension on every slab
    and on the rhs, `core.batched.stack_lanes`) of the reference's
    instances of one shape, or of one reference instance already stacked
    (`repro.service.pool.stack_instances`), whose leaves convert as they
    are."""
    from repro_torch.core.batched import stack_lanes

    if isinstance(insts, (list, tuple)):
        return stack_lanes([instance_from_reference(i, device) for i in insts])
    return instance_from_reference(insts, device)


def _lm_tree(tree, device):
    if isinstance(tree, dict):
        return {str(k): _lm_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_lm_tree(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def lm_params_from_reference(tree, device="cuda") -> dict:
    """The port's LM params (`repro_torch.models.Model`) of the reference's
    param tree, given with numpy leaves (`jax.tree.map(np.asarray, params)`):
    the same paths, stacked leading layer dimensions and the `prefix` list
    kept, every leaf in its own dtype (bfloat16 leaves bit for bit)."""
    return _lm_tree(tree, device)


def lm_cache_from_reference(cache, device="cuda") -> dict:
    """The port's decode cache of the reference's (`Model.init_cache`,
    `prefill` or `decode_step`), given with numpy leaves: the same names and
    shapes, bfloat16 and int8 leaves bit for bit."""
    return _lm_tree(cache, device)


def train_state_from_reference(state, device="cuda"):
    """The port's `TrainState` (`repro_torch.training`) of the reference's,
    given with numpy leaves (`jax.tree.map(np.asarray, state)`): params and
    both AdamW moments as `lm_params_from_reference` carries params, the
    int32 count and step as 0-dim tensors."""
    from repro_torch.training import OptState, TrainState

    return TrainState(
        params=_lm_tree(state.params, device),
        opt=OptState(m=_lm_tree(state.opt.m, device), v=_lm_tree(state.opt.v, device),
                     count=tensor_from_numpy(state.opt.count, device)),
        step=tensor_from_numpy(state.step, device),
    )
