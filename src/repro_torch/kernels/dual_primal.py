"""Python wrapper of the hand-written Hopper primal-step kernel (csrc/dual_primal.cu).

Replaces the Pallas kernel `repro/kernels/dual_primal.py::dual_primal_kernel_body`
for CUDA tensors: x = Pi_simplex(-(A^T lam + c) / gamma) for one bucket,
with x as the only output.  The wrapper checks what the kernel takes and
raises `ValueError` on anything else (the oracle's checks, `check_slab`),
plans the launch, allocates x, launches on the current stream and counts
the launch in `launches`.

Launch plan: lam is staged in shared memory when it fits beside the wide
rows' scratch and read through L1/L2 otherwise, so no instance is too large
for the kernel.  Rows of L <= 32 take 8 warps a block; wider rows take as
many warps as their two fp32 scratch rows each leave room for.  The grid is
persistent (as many blocks as fit on the card at once, at most one per
tile), so lam is staged once per block, not once per tile.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.objective import inv_gamma
from repro_torch.kernels import build
from repro_torch.kernels.dual_oracle import (
    _DTYPE_CODES,
    LaunchPlan,
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    _cdiv,
    _scan_chunk,
    check_slab,
)

__all__ = ["dual_primal", "launches", "plan_launch"]

MAX_WARPS = 8  # kMaxWarps in the kernel
UNROLL = 4  # kUnroll: 32-slot groups a warp loads together

launches = 0  # kernel launches since import (reset freely by callers)


def _smem_bytes(mJ: int, L: int, warps: int, lam_in_smem: bool) -> int:
    """Shared memory of one block: lam (when staged), then for wide rows two
    fp32 scratch rows per warp."""
    return 4 * ((mJ if lam_in_smem else 0) + (2 * warps * L if L > 32 else 0))


def plan_launch(n: int, L: int, m: int, J: int, num_sms: int) -> LaunchPlan:
    """Warps, shared memory and persistent grid for one bucket."""
    mJ = m * J
    lam_in_smem = _smem_bytes(mJ, L, 1, True) <= SMEM_PER_BLOCK
    warps = MAX_WARPS
    while warps > 1 and _smem_bytes(mJ, L, warps, lam_in_smem) > SMEM_PER_BLOCK:
        warps -= 1
    smem = _smem_bytes(mJ, L, warps, lam_in_smem)
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // (32 * warps)))
    if L <= 32:  # each warp takes UNROLL steps of 32 slots at a time
        tasks = _cdiv(_cdiv(n * L, 32), warps * UNROLL)
    else:  # one warp per row
        tasks = _cdiv(n, warps)
    grid = max(1, min(num_sms * per_sm, tasks))
    return LaunchPlan(grid, warps, lam_in_smem, smem, _scan_chunk(n, L))


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("dual_primal").dual_primal_launch
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # idx coeff cost mask lam scales
            ptr,  # x
            i64, i32, i32, i32,  # n L m J
            f32, f32, i32,  # 1/gamma radius inequality
            i32, i32, i32, i32, i32,  # dtype grid warps lam_in_smem scan_chunk
            ptr,  # stream
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def dual_primal(
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
) -> torch.Tensor:
    """Launch the kernel on one bucket: x [n, L] in the storage dtype (fp32
    for int8)."""
    global launches
    dev = cost.device
    n, L = cost.shape
    m, J, dtype = coeff.shape[0], num_destinations, cost.dtype
    quantized = check_slab("dual_primal", idx, coeff, cost, mask, lam, J,
                           coeff_scale, cost_scale)
    props = torch.cuda.get_device_properties(dev)
    plan = plan_launch(n, L, m, J, props.multi_processor_count)
    x = torch.empty((n, L), dtype=torch.float32 if quantized else dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel()(
            idx.data_ptr(), coeff.data_ptr(), cost.data_ptr(), mask.data_ptr(),
            lam.data_ptr(),
            coeff_scale.data_ptr() if quantized else None,
            cost_scale.data_ptr() if quantized else None,
            x.data_ptr(),
            n, L, m, J, inv_gamma(gamma), float(radius), int(inequality),
            _DTYPE_CODES[dtype], plan.grid, plan.warps, int(plan.lam_in_smem),
            plan.scan_chunk,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dual_primal kernel launch failed: CUDA error {rc}")
    launches += 1
    return x
