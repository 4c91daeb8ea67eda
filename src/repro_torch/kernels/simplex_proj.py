"""Python wrapper of the hand-written Hopper simplex-projection kernel (csrc/simplex_proj.cu).

Replaces the Pallas kernel `repro/kernels/simplex_proj.py::simplex_kernel_body`
for CUDA tensors: the masked Duchi projection of each row of v [n, L] onto
{w >= 0, sum(w) <= radius} (`inequality=True`) or {w >= 0, sum(w) == radius},
in fp32 or bf16, with the output in v's dtype.

A plan (`plan_simplex`) is built once per objective from the slabs' shapes
and dtype: it groups every slab of width <= 32 into one launch (wider slabs
take one launch each, `launch_groups`), lays the narrow slabs' warp tasks
end to end (`narrow_tasks`), sizes each launch's persistent grid with the
occupancy API for the instantiated kernel, and packs it into the int64
words the C entry point reads.  A call (`simplex_call`) then checks the
call's slabs against the plan, allocates the outputs and passes the v, mask
and output pointers of every slab: one `simplex_narrow` launch for the main
path's six buckets, counted in `launches`.  `simplex_proj` is the one-slab
call (a one-slab plan of the same kernel) of `UnitSimplexProjection` and
the sweeps.  The wrappers raise `ValueError` on what the kernel does not
take.

Row forms: a slab of width L <= REGISTER_MAX_WIDTH holds each row in one
thread's registers (a warp task: 32 rows); a slab of width <= 32 beyond it
is a warp segment (a warp task: UNROLL groups of 32 slots); a wider slab
takes a warp per row with two fp32 scratch rows in shared memory.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dual_oracle import (
    MAX_FUSED_LENGTH,
    MAX_SLABS,
    SMEM_PER_BLOCK,
    UNROLL,
    _cdiv,
    _scan_chunk,
)

__all__ = [
    "REGISTER_MAX_WIDTH",
    "SimplexPlan",
    "kernel_info",
    "launch_groups",
    "launches",
    "narrow_tasks",
    "plan_simplex",
    "simplex_call",
    "simplex_proj",
]

MAX_WARPS = 8  # kMaxWarps: warps of a block
REGISTER_MAX_WIDTH = 16  # kRegLogL: widest row held in one thread's registers
SLAB_WORDS = 4  # kSlabWords3: n, L, task0, scan_chunk
LAUNCH_WORDS = 7 + MAX_SLABS  # kLaunchWords3: wide grid threads smem tasks stage nslab ids

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since import (reset freely by callers)


def slab_tasks(n: int, L: int) -> int:
    """Warp tasks of a narrow slab [n, L]: 32 rows (register form) or UNROLL
    groups of 32 slots (segment form)."""
    if L <= REGISTER_MAX_WIDTH:
        return _cdiv(n, 32)
    return _cdiv(_cdiv(n * L, 32), UNROLL)


def narrow_tasks(shapes: Sequence[tuple[int, int]]) -> tuple[list[int], int]:
    """Where each narrow slab [n, L] (L <= 32) starts in a launch's task
    space, and the total."""
    task0, total = [], 0
    for n, L in shapes:
        task0.append(total)
        total += slab_tasks(n, L)
    return task0, total


def launch_groups(shapes: Sequence[tuple[int, int]]) -> list[tuple[bool, tuple[int, ...]]]:
    """The launches of one call as (wide, slab ids): the non-empty slabs of
    width <= 32 together (MAX_SLABS a launch), each wider one alone."""
    narrow = [i for i, (n, L) in enumerate(shapes) if L <= 32 and n > 0]
    groups = [(False, tuple(narrow[c:c + MAX_SLABS]))
              for c in range(0, len(narrow), MAX_SLABS)]
    return groups + [(True, (i,)) for i, (n, L) in enumerate(shapes) if L > 32 and n > 0]


def stage_bytes(L: int, dtype: torch.dtype) -> int:
    """Shared memory of one warp for a narrow slab of width L: a register
    row wider than 16 bytes passes through a stage of v and mask, each
    [32 rows][row + 16 bytes] (the padding keeps the rows' 16-byte reads
    free of bank conflicts)."""
    row = L * (4 if dtype == torch.float32 else 2)
    return 2 * 32 * (row + 16) if row > 16 and L <= REGISTER_MAX_WIDTH else 0


def wide_warps(L: int) -> int:
    """Warps of a wide block: the most (up to MAX_WARPS) whose two fp32
    scratch rows fit in shared memory."""
    return max([w for w in range(1, MAX_WARPS + 1) if 8 * w * L <= SMEM_PER_BLOCK], default=1)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch of a call."""

    wide: bool
    slabs: tuple[int, ...]  # the plan's slab ids it walks
    grid: int  # persistent blocks
    threads: int
    smem_bytes: int
    stage_bytes: int  # narrow: each warp's stage (stage_bytes)
    tasks: int  # narrow: warp tasks; wide: rows
    blocks_per_sm: int  # resident blocks (occupancy API)
    registers: int  # per thread (cudaFuncGetAttributes)
    spill_bytes: int  # local memory per thread


@dataclasses.dataclass(frozen=True, eq=False)
class SimplexPlan:
    """Everything a call needs but the slabs' pointers."""

    device: torch.device
    dtype: torch.dtype
    shapes: tuple[tuple[int, int], ...]  # [n, L] of each slab
    launches: tuple[LaunchPlan, ...]
    radius: float
    inequality: bool
    slab_words: ctypes.Array
    launch_words: ctypes.Array


_fns: dict = {}


def _fn(name: str):
    """A C entry point of the kernel library, with its argument types."""
    fn = _fns.get(name)
    if fn is None:
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn = getattr(build.load("simplex_proj"), name)
        fn.argtypes = {
            "simplex_proj_info": [i32, i32, i32, i64, ptr],
            "simplex_proj_run": [
                ptr, i32, ptr, i32,  # slab words, count, launch words, count
                ptr, i32, f32, i32, ptr,  # the call's pointers, dtype, radius inequality stream
            ],
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


@functools.lru_cache(maxsize=None)
def kernel_info(device: torch.device, dtype: torch.dtype, wide: bool, threads: int,
                smem: int) -> dict:
    """What the compiler made of one instantiation and how many of its
    blocks are resident per SM of `device` (fixed for a process, so kept)."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = _fn("simplex_proj_info")(_DTYPE_CODES[dtype], int(wide), threads, smem, out)
    if rc != 0:
        raise RuntimeError(f"simplex_proj kernel attributes: CUDA error {rc}")
    return {"max_threads": out[0], "registers": out[1], "spill_bytes": out[2],
            "blocks_per_sm": out[3]}


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"simplex_proj kernel: {msg}")


def _alignment(L: int, dtype: torch.dtype) -> int:
    """Bytes every slab pointer must be aligned to: the register form's
    widest vector access."""
    return min(16, L * (4 if dtype == torch.float32 else 2))


def plan_simplex(
    shapes: Sequence[tuple[int, int]],
    dtype: torch.dtype,
    device,
    *,
    radius: float = 1.0,
    inequality: bool = True,
    grid: Optional[int] = None,
) -> SimplexPlan:
    """The plan of a call over slabs of `shapes` [n, L] in `dtype` on one
    card: launches, grids and words, built once.  `grid` overrides the
    narrow launch's grid (tests of grid independence)."""
    device = torch.device(device)
    _require(device.type == "cuda", f"takes CUDA tensors, got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _require(dtype in _DTYPE_CODES, f"unsupported dtype {dtype}")
    _require(isinstance(radius, (int, float)), "radius must be a Python number")
    shapes = tuple((int(n), int(L)) for n, L in shapes)
    _require(len(shapes) > 0, "a plan needs at least one slab")
    for n, L in shapes:
        _require(n >= 0 and L >= 1 and L & (L - 1) == 0 and L <= MAX_FUSED_LENGTH,
                 f"width {L} must be a power of two <= {MAX_FUSED_LENGTH}")
    num_sms = torch.cuda.get_device_properties(device).multi_processor_count
    task0 = {}
    placed = []
    for wide, ids in launch_groups(shapes):
        if wide:
            n, L = shapes[ids[0]]
            warps, tasks, stage = wide_warps(L), n, 0
            smem = 8 * warps * L
        else:
            starts, tasks = narrow_tasks([shapes[i] for i in ids])
            task0.update(zip(ids, starts))
            stage = max(stage_bytes(shapes[i][1], dtype) for i in ids)
            warps, smem = MAX_WARPS, MAX_WARPS * stage
        info = kernel_info(device, dtype, wide, 32 * warps, smem)
        _require(info["blocks_per_sm"] >= 1,
                 f"no block of {32 * warps} threads and {smem} B fits on an SM")
        g = max(1, min(num_sms * info["blocks_per_sm"], _cdiv(tasks, warps)))
        if grid is not None and not wide:
            g = grid
        placed.append(LaunchPlan(wide, ids, g, 32 * warps, smem, stage, tasks,
                                 info["blocks_per_sm"], info["registers"], info["spill_bytes"]))
    words = (ctypes.c_longlong * (SLAB_WORDS * len(shapes)))()
    for i, (n, L) in enumerate(shapes):
        words[SLAB_WORDS * i:SLAB_WORDS * (i + 1)] = [
            n, L, task0.get(i, 0), _scan_chunk(n, L) if L > 32 else L]
    lwords = (ctypes.c_longlong * (LAUNCH_WORDS * max(1, len(placed))))()
    for k, p in enumerate(placed):
        ids = list(p.slabs) + [0] * (MAX_SLABS - len(p.slabs))
        lwords[LAUNCH_WORDS * k:LAUNCH_WORDS * (k + 1)] = [
            int(p.wide), p.grid, p.threads, p.smem_bytes, p.tasks, p.stage_bytes,
            len(p.slabs), *ids]
    return SimplexPlan(device=device, dtype=dtype, shapes=shapes, launches=tuple(placed),
                       radius=float(radius), inequality=bool(inequality), slab_words=words,
                       launch_words=lwords)


def _refuse(t: torch.Tensor, plan: SimplexPlan, shape: tuple[int, int], align: int) -> None:
    """Raises the reason why the call's slab `t` does not fit `plan`."""
    _require(t.dtype == plan.dtype, f"v and mask must share one dtype, the plan's {plan.dtype}")
    _require(t.shape == shape, f"v and mask must be {list(shape)} as planned")
    _require(t.device == plan.device, f"tensors must be on {plan.device}")
    _require(t.is_contiguous(), "tensors must be contiguous")
    _require(False, f"rows of {shape[1]} must start {align}-byte aligned")


def simplex_call(plan: SimplexPlan, vs: Sequence[torch.Tensor],
                 masks: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """One call of a plan: the projection of every slab, in the plan's
    dtype.  Each v and mask must have the plan's shape, dtype and device,
    be contiguous and aligned to its row's vector access."""
    global launches
    _require(len(vs) == len(plan.shapes) and len(masks) == len(plan.shapes),
             f"the plan takes {len(plan.shapes)} slabs")
    dev, dtype = plan.device, plan.dtype
    outs, ptrs = [], []
    for v, mask, shape in zip(vs, masks, plan.shapes):
        align = _alignment(shape[1], dtype)
        for t in (v, mask):
            ptr = t.data_ptr()
            if (t.dtype != dtype or t.shape != shape or t.device != dev
                    or not t.is_contiguous() or ptr % align):
                _refuse(t, plan, shape, align)
            ptrs.append(ptr)
        out = torch.empty(shape, dtype=dtype, device=dev)
        outs.append(out)
        ptrs.append(out.data_ptr())
    with torch.cuda.device(dev):
        rc = _fn("simplex_proj_run")(
            plan.slab_words, len(plan.shapes), plan.launch_words, len(plan.launches),
            (ctypes.c_longlong * len(ptrs))(*ptrs), _DTYPE_CODES[dtype], plan.radius,
            int(plan.inequality),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"simplex_proj kernel launch failed: CUDA error {rc}")
    launches += len(plan.launches)
    return tuple(outs)


def simplex_proj(
    v: torch.Tensor,  # [n, L] fp32 / bf16
    mask: torch.Tensor,  # [n, L] v's dtype
    radius: float = 1.0,
    *,
    inequality: bool = True,
) -> torch.Tensor:
    """The kernel on [n, L] rows, planned for this call: the projection, in
    v's dtype."""
    _require(v.device.type == "cuda", f"takes CUDA tensors, got {v.device}")
    _require(v.ndim == 2, "v must be [n, L]")
    plan = plan_simplex([tuple(v.shape)], v.dtype, v.device, radius=radius,
                        inequality=inequality)
    return simplex_call(plan, [v], [mask])[0]
