"""Python wrapper of the hand-written Hopper dual-oracle kernel (csrc/dual_oracle.cu).

Replaces the Pallas kernel `repro/kernels/dual_oracle.py::dual_oracle_kernel_body`
for CUDA tensors.  The wrapper checks what the kernel takes and raises on
anything else, plans the launch (warps per block, persistent grid, whether
lam is staged in shared memory) from the card's shared memory, allocates the
outputs, launches on the current stream and counts the launch in `launches`.

Capacity (replaces the TPU's one-hot VMEM gate `fits_onehot_budget`): the
fp32 [m, J] histogram lives in shared memory, one per block for widths
L <= 32 (beside a tile's staging area) and one per warp, with two fp32
rows of scratch, for wider rows, within the 227 KB a block may use.  lam is
staged beside them when it fits and read through L1/L2 otherwise.  An
instance too large for that raises `ValueError`; it is never routed to the
plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.core.objective import inv_gamma
from repro_torch.kernels import build

__all__ = [
    "LaunchPlan",
    "MAX_FAMILIES",
    "MAX_FUSED_LENGTH",
    "check_slab",
    "dual_oracle",
    "launches",
    "plan_launch",
]

MAX_FUSED_LENGTH = 8192  # widest slab the kernel takes (the reference's limit)
MAX_FAMILIES = 8  # kMaxFamilies in the kernel: coefficients held in registers
MAX_WARPS = 8  # kMaxWarps: warps per block
UNROLL = 4  # kUnroll: 32-slot groups a warp loads together
SMEM_PER_BLOCK = 232_448  # 227 KB of opt-in shared memory per block (H100)
SMEM_PER_SM = 233_472  # 228 KB per SM, 1 KB of it reserved per resident block
_RED_FLOATS = 2 * MAX_WARPS

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launches = 0  # kernel launches since import (reset freely by callers)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    grid: int  # persistent blocks; also the leading dim of the partials
    warps: int  # warps per block
    lam_in_smem: bool
    smem_bytes: int
    scan_chunk: int  # wide rows: chunk of the cumsum order (see _scan_chunk)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _scan_chunk(n: int, L: int) -> int:
    """Chunk length of PyTorch's CUDA cumsum along rows of L for n rows
    (`get_log_num_threads_x_inner_scan` in ATen's ScanUtils.cuh, uint32
    arithmetic included): the kernel scans in the same order, so its cutoff
    sums round exactly as the plain version's do."""
    lx, ly = (L - 1).bit_length(), (max(n, 1) - 1).bit_length()
    log_x = ((9 + ((lx - ly) & 0xFFFFFFFF)) & 0xFFFFFFFF) // 2
    return min(2 << min(max(4, log_x), 9), L)


def _smem_floats(mJ: int, m: int, L: int, warps: int, lam_in_smem: bool) -> int:
    """Shared memory of one block, as the kernel lays it out: lam (when
    staged), the histogram(s), the reduction slots, then for narrow rows
    (L <= 32) one block histogram and the staging area of a tile (keys, m
    value rows, counts), for wide rows one histogram and two rows per warp."""
    if L <= 32:
        tail = mJ + (1 + m) * warps * UNROLL * 32 + warps
    else:
        tail = warps * mJ + 2 * warps * L
    return (mJ if lam_in_smem else 0) + _RED_FLOATS + tail


def plan_launch(n: int, L: int, m: int, J: int, num_sms: int) -> LaunchPlan:
    """Warps, shared memory and persistent grid for one bucket."""
    mJ = m * J
    if L <= 32:  # one block histogram shared by MAX_WARPS owner warps
        warps = MAX_WARPS
        lam_in_smem = 4 * _smem_floats(mJ, m, L, warps, True) <= SMEM_PER_BLOCK
    else:  # as many warps, each with its histogram and rows, as fit
        lam_in_smem = 4 * _smem_floats(mJ, m, L, 1, True) <= SMEM_PER_BLOCK
        warps = MAX_WARPS
        while warps and 4 * _smem_floats(mJ, m, L, warps, lam_in_smem) > SMEM_PER_BLOCK:
            warps -= 1
    smem = 4 * _smem_floats(mJ, m, L, max(warps, 1), lam_in_smem)
    if warps < 1 or smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"dual-oracle kernel capacity exceeded: the fp32 [m, J] histogram "
            f"({m} x {J}) of width-{L} rows needs {smem} B of shared memory, "
            f"above the {SMEM_PER_BLOCK} B a block may use"
        )
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // (32 * warps)))
    if L <= 32:  # tiles of warps * UNROLL steps of 32 slots
        tasks = _cdiv(_cdiv(n * L, 32), warps * UNROLL)
    else:  # one warp per row
        tasks = _cdiv(n, warps)
    grid = max(1, min(num_sms * per_sm, tasks))
    return LaunchPlan(grid, warps, lam_in_smem, smem, _scan_chunk(n, L))


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.load("dual_oracle")
        fn = lib.dual_oracle_launch
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # idx coeff cost mask lam scales
            ptr, ptr, ptr,  # x hist scal
            i64, i32, i32, i32,  # n L m J
            f32, f32, i32,  # 1/gamma radius inequality
            i32, i32, i32, i32, i32,  # dtype grid warps lam_in_smem scan_chunk
            ptr,  # stream
        ]
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _require(ok: bool, msg: str, kernel: str = "dual_oracle") -> None:
    if not ok:
        raise ValueError(f"{kernel} kernel: {msg}")


def check_slab(kernel, idx, coeff, cost, mask, lam, J, coeff_scale, cost_scale):
    """Raises `ValueError` on what the slab kernels (the oracle and the
    primal step) do not take; returns whether the slab is int8."""
    dev = cost.device
    need = lambda ok, msg: _require(ok, msg, kernel)
    need(dev.type == "cuda", f"takes CUDA tensors, got {dev}")
    n, L = cost.shape
    m = coeff.shape[0]
    dtype = cost.dtype
    need(dtype in _DTYPE_CODES, f"unsupported slab dtype {dtype}")
    need(coeff.dtype == dtype and mask.dtype == dtype,
         "coeff, cost and mask must share one dtype")
    need(idx.dtype == torch.int32, f"idx must be int32, got {idx.dtype}")
    need(tuple(idx.shape) == (n, L) and tuple(mask.shape) == (n, L)
         and tuple(coeff.shape) == (m, n, L), "inconsistent slab shapes")
    need(L >= 1 and L & (L - 1) == 0 and L <= MAX_FUSED_LENGTH,
         f"width {L} must be a power of two <= {MAX_FUSED_LENGTH}")
    need(1 <= m <= MAX_FAMILIES, f"{m} families, at most {MAX_FAMILIES}")
    need(lam.dtype == torch.float32 and lam.numel() == m * J,
         f"lam must be fp32 with {m * J} entries")
    quantized = dtype == torch.int8
    need(quantized == (coeff_scale is not None)
         and quantized == (cost_scale is not None),
         "int8 slabs need coeff_scale and cost_scale; float slabs take none")
    tensors = [idx, coeff, cost, mask, lam]
    if quantized:
        need(coeff_scale.dtype == torch.float32 and coeff_scale.numel() == m
             and cost_scale.dtype == torch.float32 and cost_scale.numel() == 1,
             "scales must be fp32 [m, 1, 1] and [1, 1]")
        tensors += [coeff_scale, cost_scale]
    need(all(t.device == dev for t in tensors), "all tensors on one device")
    need(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    return quantized


def dual_oracle(
    idx: torch.Tensor,  # [n, L] int32
    coeff: torch.Tensor,  # [m, n, L] fp32 / bf16 / int8
    cost: torch.Tensor,  # [n, L] slab dtype
    mask: torch.Tensor,  # [n, L] slab dtype
    lam: torch.Tensor,  # [m * J] fp32
    gamma: float,
    *,
    num_destinations: int,
    radius: float = 1.0,
    inequality: bool = True,
    coeff_scale: Optional[torch.Tensor] = None,  # [m, 1, 1] f32 (int8 slabs)
    cost_scale: Optional[torch.Tensor] = None,  # [1, 1] f32 (int8 slabs)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on one bucket: `(x, hist_partials, scal_partials)`.

    x [n, L] is in the storage dtype (fp32 for int8); hist_partials
    [grid, m, J] and scal_partials [grid, 2] = (c'x, ||x||^2) are fp32
    per-block partials for the caller to sum over the grid axis.
    """
    global launches
    dev = cost.device
    n, L = cost.shape
    m, J, dtype = coeff.shape[0], num_destinations, cost.dtype
    quantized = check_slab("dual_oracle", idx, coeff, cost, mask, lam, J,
                           coeff_scale, cost_scale)
    props = torch.cuda.get_device_properties(dev)
    plan = plan_launch(n, L, m, J, props.multi_processor_count)
    out_dtype = torch.float32 if quantized else dtype
    x = torch.empty((n, L), dtype=out_dtype, device=dev)
    hist = torch.empty((plan.grid, m, J), dtype=torch.float32, device=dev)
    scal = torch.empty((plan.grid, 2), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(
            idx.data_ptr(), coeff.data_ptr(), cost.data_ptr(), mask.data_ptr(),
            lam.data_ptr(),
            coeff_scale.data_ptr() if quantized else None,
            cost_scale.data_ptr() if quantized else None,
            x.data_ptr(), hist.data_ptr(), scal.data_ptr(),
            n, L, m, J, inv_gamma(gamma), float(radius), int(inequality),
            _DTYPE_CODES[dtype], plan.grid, plan.warps, int(plan.lam_in_smem),
            plan.scan_chunk,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dual_oracle kernel launch failed: CUDA error {rc}")
    launches += 1
    return x, hist, scal
