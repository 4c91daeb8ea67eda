"""Python wrapper of the hand-written Hopper simplex-projection kernel (csrc/simplex_proj.cu).

Replaces the Pallas kernel `repro/kernels/simplex_proj.py::simplex_kernel_body`
for CUDA tensors: the masked Duchi projection of each row of v [n, L] onto
{w >= 0, sum(w) <= radius} (`inequality=True`) or {w >= 0, sum(w) == radius},
in fp32 or bf16, with the output in v's dtype.  The wrapper checks what the
kernel takes and raises `ValueError` on anything else, plans the launch,
allocates the output, launches on the current stream and counts the launch
in `launches`.

Launch plan: rows of L <= 32 need no shared memory and take 8 warps a
block; wider rows take as many warps as their two fp32 scratch rows each
leave room for.  The grid is persistent: as many blocks as fit on the card
at once, at most one per tile.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dual_oracle import (
    MAX_FUSED_LENGTH,
    SMEM_PER_BLOCK,
    _cdiv,
    _scan_chunk,
)

__all__ = ["launches", "plan_launch", "simplex_proj"]

MAX_WARPS = 8  # kMaxWarps in the kernel
UNROLL = 4  # kUnroll: 32-slot groups a warp loads together
SMEM_PER_SM = 233_472  # 228 KB per SM, 1 KB of it reserved per resident block

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since import (reset freely by callers)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    grid: int  # persistent blocks
    warps: int  # warps per block
    smem_bytes: int
    scan_chunk: int  # wide rows: chunk of the cumsum order (see _scan_chunk)


def plan_launch(n: int, L: int, num_sms: int) -> LaunchPlan:
    """Warps, shared memory and persistent grid for [n, L] rows."""
    row_bytes = 2 * 4 * L if L > 32 else 0  # a wide row's two scratch rows
    warps = MAX_WARPS
    while warps > 1 and warps * row_bytes > SMEM_PER_BLOCK:
        warps -= 1
    smem = warps * row_bytes
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // (32 * warps)))
    if L <= 32:  # each warp takes UNROLL steps of 32 slots at a time
        tasks = _cdiv(_cdiv(n * L, 32), warps * UNROLL)
    else:  # one warp per row
        tasks = _cdiv(n, warps)
    grid = max(1, min(num_sms * per_sm, tasks))
    return LaunchPlan(grid, warps, smem, _scan_chunk(n, L))


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("simplex_proj").simplex_proj_launch
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [
            ptr, ptr, ptr,  # v mask out
            i64, i32,  # n L
            f32, i32,  # radius inequality
            i32, i32, i32, i32,  # dtype grid warps scan_chunk
            ptr,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"simplex_proj kernel: {msg}")


def simplex_proj(
    v: torch.Tensor,  # [n, L] fp32 / bf16
    mask: torch.Tensor,  # [n, L] v's dtype
    radius: float = 1.0,
    *,
    inequality: bool = True,
) -> torch.Tensor:
    """Launch the kernel on [n, L] rows: the projection, in v's dtype."""
    global launches
    dev = v.device
    _require(dev.type == "cuda", f"takes CUDA tensors, got {dev}")
    _require(v.dtype in _DTYPE_CODES, f"unsupported dtype {v.dtype}")
    _require(mask.dtype == v.dtype, "v and mask must share one dtype")
    _require(v.ndim == 2 and tuple(mask.shape) == tuple(v.shape),
             "v and mask must be [n, L] of one shape")
    n, L = v.shape
    _require(L >= 1 and L & (L - 1) == 0 and L <= MAX_FUSED_LENGTH,
             f"width {L} must be a power of two <= {MAX_FUSED_LENGTH}")
    _require(isinstance(radius, (int, float)), "radius must be a Python number")
    _require(mask.device == dev, "v and mask on one device")
    _require(v.is_contiguous() and mask.is_contiguous(), "tensors must be contiguous")
    plan = plan_launch(n, L, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty_like(v)
    with torch.cuda.device(dev):
        rc = _kernel()(
            v.data_ptr(), mask.data_ptr(), out.data_ptr(), n, L,
            float(radius), int(inequality), _DTYPE_CODES[v.dtype],
            plan.grid, plan.warps, plan.scan_chunk,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"simplex_proj kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
