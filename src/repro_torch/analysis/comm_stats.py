"""Collectives, FLOPs and live bytes of one traced step, per device (the
port's counterpart of `repro.analysis.hlo_stats`).

The reference parses compiled HLO text: every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute contributes its *operand*
bytes (the payload entering the network on each device).  PyTorch compiles
nothing, so the port reads the same quantities from an eager trace:
`TraceCounter` is a `TorchDispatchMode` that lets DTensor desugar each op
into local ops and `_c10d_functional` collectives first (it returns
NotImplemented for DTensor arguments, as `CommDebugMode` does), then sees
every local op, and records

  * each collective's kind and operand bytes (`collective_stats` sums them
    under the reference's kind names; PyTorch's broadcast, which XLA does
    not emit, is counted as "broadcast");
  * the FLOPs of the local ops by `torch.utils.flop_counter`'s formulas
    (the table `FlopCounterMode` counts with);
  * the peak of the bytes of the tensors the trace itself allocated and
    keeps alive (activations, grads, temporaries, gathered copies; the
    storages of the step's inputs are excluded).

An eager trace visits every layer, so its counts are loop-aware by
construction; the reference's body-once "static" count has no
counterpart.  Works on meta tensors (no storage), under the fake process
group of the dry run.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["TraceCounter", "collective_stats", "shard_bytes", "COLLECTIVE_KINDS"]

# op name (without namespace) -> the reference's kind name
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def shard_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in `tree`."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class TraceCounter(TorchDispatchMode):
    """Counts what the ops run under it do on this device (see the module's
    docstring).  Storages an op reads before the trace made them (the
    step's inputs) are not counted as the trace's own."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.ops: list[tuple[str, int, tuple]] = []
        self.live = 0
        self.peak = 0
        self._live: dict[int, list] = {}
        self._seen_inputs: set[int] = set()
        self._active = True

    def __exit__(self, *exc):
        self._active = False
        return super().__exit__(*exc)

    # -- live bytes ------------------------------------------------------------
    def _drop(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None or not self._active:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._live[key]
            self.live -= entry[0]

    def _track(self, out) -> None:
        for t in _tensors(out):
            if hasattr(t, "placements"):
                continue
            key = _storage_key(t)
            if key in self._seen_inputs:
                continue
            entry = self._live.get(key)
            if entry is None:
                entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
                self.live += entry[0]
                self.peak = max(self.peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._drop, key)

    def _note_inputs(self, args) -> None:
        for t in _tensors(args):
            if hasattr(t, "placements"):
                continue
            key = _storage_key(t)
            if key not in self._live:
                self._seen_inputs.add(key)

    # -- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        names = {getattr(t, "__name__", "") for t in types}
        if "DTensor" in names:
            return NotImplemented  # let DTensor desugar into local ops first
        out = func(*args, **kwargs)
        if "FakeTensor" in names or any(type(t).__name__ == "FakeTensor"
                                        for t in _tensors(out)):
            # DTensor's sharding propagation infers output shapes on
            # FakeTensors of the global shapes: no work of this device
            return out
        self._note_inputs((args, kwargs))
        packet = func._overloadpacket
        ns, _, name = packet._qualified_op_name.partition("::")
        if ns in _NAMESPACES and name in COLLECTIVE_KINDS:
            first = next(_tensors(args), None)
            size = 0 if first is None else sum(_nbytes(t) for t in _tensors(args[0]))
            shape = tuple(first.shape) if first is not None else ()
            self.ops.append((COLLECTIVE_KINDS[name], size, shape))
        elif packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](*args, **kwargs, out_val=out))
        self._track(out)
        return out

    def account(self, **extra) -> dict:
        """The trace's per-device account, with `extra` fields added."""
        coll = collective_stats(self.ops)
        return {
            "flop_counter_flops_per_device": self.flops,
            "collectives": {"counts": coll["counts"], "bytes": coll["bytes"]},
            "coll_bytes_per_device": coll["total_bytes"],
            "trace_live_peak_bytes": self.peak,
            **extra,
        }


def collective_stats(trace) -> dict:
    """Per-kind collective op counts and payload bytes (per device) of a
    `TraceCounter` (or its `ops` list): the reference's dict,
    {"counts": {kind: n}, "bytes": {kind: B}, "total_bytes": B,
     "ops": [(kind, bytes, operand shape)]}."""
    ops = trace.ops if isinstance(trace, TraceCounter) else list(trace)
    counts: dict[str, int] = defaultdict(int)
    byts: dict[str, int] = defaultdict(int)
    for kind, size, _ in ops:
        counts[kind] += 1
        byts[kind] += size
    return {
        "counts": dict(counts),
        "bytes": dict(byts),
        "total_bytes": int(sum(byts.values())),
        "ops": list(ops),
    }
