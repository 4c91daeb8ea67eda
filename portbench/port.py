"""Between the benchmark's plain data and the port's entry points: the edge
list and deltas handed to the program in its own types, and the program's
packed slabs handed back to the judge as plain tensors."""
from __future__ import annotations

import numpy as np
import torch

from portbench.generator import Delta, Edges
from portbench.reference.judge import ProgramSlabs

__all__ = ["edge_list", "instance_delta", "program_slabs", "shapes"]


def edge_list(edges: Edges, cfg: dict):
    """The program's `EdgeListInstance` of the benchmark's edge list."""
    from repro_torch.instances import EdgeListInstance, MatchingInstanceSpec

    spec = MatchingInstanceSpec(
        num_sources=edges.num_sources, num_destinations=edges.num_destinations,
        avg_degree=cfg["avg_degree"], num_families=edges.num_families,
        breadth_sigma=cfg["breadth_sigma"], value_sigma=cfg["value_sigma"],
        responsiveness_sigma=cfg["responsiveness_sigma"], noise_sigma=cfg["noise_sigma"],
        scale_sigma=cfg["scale_sigma"], c_max=cfg["c_max"], rhs_eps=cfg["rhs_eps"],
    )
    return EdgeListInstance(spec=spec, src=edges.src, dst=edges.dst, values=edges.values,
                            coeff=edges.coeff, rhs=edges.rhs)


def instance_delta(d: Delta):
    """The program's `InstanceDelta` of one delta."""
    from repro_torch.instances import InstanceDelta

    return InstanceDelta(
        insert_src=d.insert_src, insert_dst=d.insert_dst, insert_values=d.insert_values,
        insert_coeff=d.insert_coeff, delete_src=d.delete_src, delete_dst=d.delete_dst,
        update_src=d.update_src, update_dst=d.update_dst, update_values=d.update_values,
        rhs=d.rhs,
    )


def program_slabs(instance, sources, xs=None) -> ProgramSlabs:
    """A packed instance's slabs (and primal slabs `xs`), each row named by
    `sources` [per bucket, the source of each row or -1]."""
    buckets = [{"idx": b.idx, "cost": b.cost, "coeff": b.coeff, "mask": b.mask}
               for b in instance.buckets]
    srcs = [torch.as_tensor(np.asarray(s, np.int64)) for s in sources]
    return ProgramSlabs(buckets, srcs, xs)


def shapes(instance) -> dict:
    """The packed instance's shapes, which the roofline counts read."""
    return {"buckets": [[b.length, b.rows] for b in instance.buckets],
            "families": instance.num_families,
            "destinations": instance.num_destinations,
            "slab_dtype": str(instance.buckets[0].cost.dtype).removeprefix("torch.")}
