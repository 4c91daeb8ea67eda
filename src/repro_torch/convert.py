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
(`formulation_from_reference`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import formulation as tform
from repro_torch.device import resolve_device
from repro_torch.instances.buckets import Bucket, BucketedInstance

__all__ = [
    "formulation_from_reference",
    "instance_from_reference",
    "lam_from_numpy",
    "tensor_from_numpy",
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
