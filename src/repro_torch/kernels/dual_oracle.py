"""Python wrapper of the hand-written Hopper dual-oracle kernel (csrc/dual_oracle.cu).

Replaces the Pallas kernel `repro/kernels/dual_oracle.py::dual_oracle_kernel_body`
for CUDA tensors, and the tree-sum of its partials.  Also the plan that the
primal-step kernel (`kernels/dual_primal.py`) shares.

A plan (`plan_slabs`) is built once per objective from the static slabs:
it checks them (`check_slab`), groups every bucket of width <= 32 into one
launch (wider buckets take one launch each), lays out each launch's shared
memory (`oracle_layout` / `primal_layout`), sizes its persistent grid with
the occupancy API for the instantiated kernel, fixes the fixed-point
`shift` of A x (`fixed_point_shift`), and packs all of it into the int64
words the C entry point reads.  A call (`oracle_call`) then only allocates
the outputs and passes lam, 1/gamma and the output pointers: one
`oracle_narrow` launch for the main path's six buckets, then one
`oracle_finalize`, counted in `launches` and `finalize_launches`.

The tenant axis (`plan_batched`, the batched multi-tenant solve): over B
stacked instances of one shape ([B, ...] slabs) the plan is lane 0's plan
with B lanes (gridDim.y = B) and a fixed-point shift per lane, since each
lane's coefficients fix its own.  A batched call is the same launches as a
solo one, whatever B, and each lane's x, A x, c'x and ||x||^2 are bitwise
its solo call's.  A batched call takes one gamma for every lane or a [B]
tensor of them (`lane_inv_gamma`: each lane's 1/gamma_b in a [B] fp32
table on the card, read once per block), which is what the batched PDHG
prox step needs: its gamma_b = 1/tau_b differs per lane.

Capacity (replaces the TPU's one-hot VMEM gate `fits_onehot_budget`): the
int64 [m, J] histogram lives in shared memory when it fits (with lam beside
it when that fits too; each block adds it into one global row at its end),
else in the global row itself (L2 atomics), so every (n, L <= 8192, m <= 8,
J) runs; an instance is never routed to the plain version.  `dual_oracle` is the single-bucket call the sweeps and the
per-bucket times use.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.objective import inv_gamma
from repro_torch.kernels import build

__all__ = [
    "FIXED_POINT_BITS",
    "HIST_GLOBAL",
    "HIST_SHARED",
    "Layout",
    "LaunchPlan",
    "MAX_FAMILIES",
    "MAX_FUSED_LENGTH",
    "Slab",
    "SlabPlan",
    "check_slab",
    "dual_oracle",
    "family_template",
    "finalize_launches",
    "fixed_point_shift",
    "kernel_info",
    "lane_inv_gamma",
    "launches",
    "narrow_tasks",
    "oracle_call",
    "oracle_finalize",
    "oracle_layout",
    "plan_batched",
    "plan_slabs",
    "primal_layout",
]

MAX_FUSED_LENGTH = 8192  # widest slab the kernel takes (the reference's limit)
MAX_FAMILIES = 8  # largest template family count M
MAX_SLABS = 16  # kMaxSlabs: buckets one launch walks
UNROLL = 4  # kUnroll: 32-slot groups a warp loads together
WIDE_WARPS = 8  # kWideWarps: most warps of a wide-row block
SLAB_WORDS = 12  # kSlabWords: int64 words per bucket
LAUNCH_WORDS = 9 + MAX_SLABS  # kLaunchWords: int64 words per launch
SMEM_PER_BLOCK = 232_448  # 227 KB of opt-in shared memory per block (H100)
RED_BYTES = 256  # the block reduction's slots (2 x 32 warps x fp32)
HIST_SHARED, HIST_GLOBAL = 0, 1  # kHistShared / kHistGlobal
FIXED_POINT_BITS = 62  # |any A x partial or total| * 2^shift <= 2^62
MAX_SHIFT = 100  # 2^shift and 2^-shift stay normal fp32 numbers
FINALIZE_THREADS = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launches = 0  # oracle kernel launches since import (reset freely by callers)
finalize_launches = 0  # finalize kernel launches since import
_count_lock = threading.Lock()  # callers launch from several threads


@dataclasses.dataclass(frozen=True)
class Slab:
    """One bucket's slab as the kernels take it (`Bucket` has these fields)."""

    idx: torch.Tensor  # [n, L] int32
    coeff: torch.Tensor  # [m, n, L] fp32 / bf16 / int8
    cost: torch.Tensor  # [n, L] slab dtype
    mask: torch.Tensor  # [n, L] slab dtype
    coeff_scale: Optional[torch.Tensor] = None  # [m, 1, 1] f32 (int8 slabs)
    cost_scale: Optional[torch.Tensor] = None  # [1, 1] f32 (int8 slabs)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align16(b: int) -> int:
    return (b + 15) & ~15


def family_template(m: int) -> int:
    """The kernels' template family count M for m families: 1, 2, 4 or 8."""
    if not 1 <= m <= MAX_FAMILIES:
        raise ValueError(f"{m} families, at most {MAX_FAMILIES}")
    return 1 << (m - 1).bit_length()


def narrow_threads(M: int) -> int:
    """Threads of a narrow-row block (narrow_threads<M>() in the kernels)."""
    return 1024 if M <= 2 else 512


def _scan_chunk(n: int, L: int) -> int:
    """Chunk length of PyTorch's CUDA cumsum along rows of L for n rows
    (`get_log_num_threads_x_inner_scan` in ATen's ScanUtils.cuh, uint32
    arithmetic included): the kernel scans in the same order, so its cutoff
    sums round exactly as the plain version's do."""
    lx, ly = (L - 1).bit_length(), (max(n, 1) - 1).bit_length()
    log_x = ((9 + ((lx - ly) & 0xFFFFFFFF)) & 0xFFFFFFFF) // 2
    return min(2 << min(max(4, log_x), 9), L)


def narrow_tasks(shapes: Sequence[tuple[int, int]]) -> tuple[list[int], int]:
    """Where each narrow slab [n, L] (L <= 32) starts in a launch's task
    space, and the total: a warp task is UNROLL groups of 32 consecutive
    slots of one slab, i.e. whole rows."""
    task0, total = [], 0
    for n, L in shapes:
        task0.append(total)
        total += _cdiv(_cdiv(n * L, 32), UNROLL)
    return task0, total


@dataclasses.dataclass(frozen=True)
class Layout:
    """Shared memory of one launch's blocks (pure arithmetic, no card)."""

    hist_mode: int  # HIST_SHARED or HIST_GLOBAL (the oracle's histogram)
    lam_in_smem: bool
    warps: int  # warps per block
    smem_bytes: int


def _oracle_smem(mJ: int, hist: bool, lam: bool, warps: int, L: int) -> int:
    """As oracle_prologue lays it out: the int64 histogram (unless global),
    lam (when staged), the reduction slots, then for wide rows two fp32 rows
    per warp."""
    rows = 8 * warps * L if L > 32 else 0
    return ((_align16(8 * mJ) if hist else 0) + (_align16(4 * mJ) if lam else 0)
            + RED_BYTES + rows)


def _primal_smem(mJ: int, lam: bool, warps: int, L: int) -> int:
    """As primal_narrow / primal_wide lay it out: lam (when staged), then for
    wide rows two fp32 rows per warp."""
    return (_align16(4 * mJ) if lam else 0) + (8 * warps * L if L > 32 else 0)


def _widest(fits, L: int, M: int) -> int:
    """Warps per block: all of a narrow block's; for wide rows the most (up
    to WIDE_WARPS) whose scratch rows fit."""
    if L <= 32:
        return narrow_threads(M) // 32
    return max([w for w in range(1, WIDE_WARPS + 1) if fits(w)], default=1)


def oracle_layout(L: int, m: int, J: int) -> Layout:
    """The oracle's histogram in shared memory when it fits beside one
    block's (narrow) or one warp's (wide) scratch, lam beside it when that
    fits too; else the histogram in one global row."""
    mJ, M = m * J, family_template(m)
    least = narrow_threads(M) // 32 if L <= 32 else 1
    hist = _oracle_smem(mJ, True, False, least, L) <= SMEM_PER_BLOCK
    lam = _oracle_smem(mJ, hist, True, least, L) <= SMEM_PER_BLOCK
    warps = _widest(lambda w: _oracle_smem(mJ, hist, lam, w, L) <= SMEM_PER_BLOCK, L, M)
    smem = _oracle_smem(mJ, hist, lam, warps, L)
    if smem > SMEM_PER_BLOCK:  # a wide row alone fills shared memory
        raise ValueError(f"dual_oracle kernel: rows of {L} need {smem} B of shared memory")
    return Layout(HIST_SHARED if hist else HIST_GLOBAL, lam, warps, smem)


def primal_layout(L: int, m: int, J: int) -> Layout:
    """The primal step's lam in shared memory when it fits beside one warp's
    scratch rows (wide) or alone (narrow)."""
    mJ, M = m * J, family_template(m)
    lam = _primal_smem(mJ, True, 1, L) <= SMEM_PER_BLOCK
    warps = _widest(lambda w: _primal_smem(mJ, lam, w, L) <= SMEM_PER_BLOCK, L, M)
    return Layout(HIST_SHARED, lam, warps, _primal_smem(mJ, lam, warps, L))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch of a call."""

    wide: bool
    slabs: tuple[int, ...]  # the plan's slab ids it walks
    grid: int  # persistent blocks
    threads: int
    layout: Layout
    scal_row: int  # first (c'x, ||x||^2) row it writes, one per block
    tasks: int  # narrow: warp tasks; wide: rows
    blocks_per_sm: int  # resident blocks (occupancy API)
    registers: int  # per thread (cudaFuncGetAttributes)
    spill_bytes: int  # local memory per thread


@dataclasses.dataclass(frozen=True, eq=False)
class SlabPlan:
    """Everything a call of one kernel needs but lam and 1/gamma."""

    kernel: str  # "dual_oracle" or "dual_primal"
    device: torch.device
    m: int
    J: int
    M: int  # template family count
    dtype: torch.dtype
    out_dtype: torch.dtype
    shapes: tuple[tuple[int, int], ...]  # [n, L] of each slab
    launches: tuple[LaunchPlan, ...]
    radius: float
    inequality: bool
    shift: int  # fixed point of A x (the oracle)
    scal_rows: int  # blocks of all launches (the oracle), per lane
    finalize_grid: int
    slab_words: ctypes.Array
    launch_words: ctypes.Array
    slab_tensors: tuple  # keeps the slabs the words point into alive
    # the tenant axis (`plan_batched`): lanes (0: a solo plan, whose calls
    # take and return no lane dimension), each lane's shift, and [2, lanes]
    # fp32 on the card holding 2^shift and 2^-shift of each lane
    lanes: int = 0
    lane_shifts: tuple[int, ...] = ()
    lane_q: Optional[torch.Tensor] = None


_fns: dict = {}


def _fn(name: str):
    """A C entry point of a kernel library, with its argument types."""
    fn = _fns.get(name)
    if fn is None:
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib = build.load("dual_oracle" if name.startswith("dual_oracle") else "dual_primal")
        rows_run = [ptr, i32, ptr, i32, i32, i32, i32, i32, ptr, ptr, i64, f32, f32, i32, ptr]
        fn = getattr(lib, name)
        fn.argtypes = {
            "dual_oracle_info": [i32, i32, i32, i32, i64, ptr],
            "dual_primal_info": [i32, i32, i32, i32, i64, ptr],
            "dual_primal_rows_info": [i32, i32, i32, i32, i64, ptr],
            "dual_oracle_run": [
                ptr, i32, ptr, i32,  # slab words, count, launch words, count
                i32, i32, i32, i32,  # dtype M m J
                ptr, ptr,  # lam, x pointers
                ptr, ptr, i32,  # the int64 row, the (c'x, ||x||^2) rows and their count
                ptr, ptr,  # ax, (c'x, ||x||^2)
                f32, f32, i32, i32, i32,  # 1/gamma radius inequality shift finalize grid
                i32, ptr,  # lanes, per-lane 2^shift and 2^-shift
                ptr,  # per-lane 1/gamma, or null
                ptr,  # stream
            ],
            "dual_primal_rows_run": rows_run,
            "dual_oracle_finalize": [ptr, i32, ptr, i32, i32, ptr, ptr, i32, ptr],
            "dual_primal_run": [
                ptr, i32, ptr, i32, i32, i32, i32, i32, ptr, ptr, f32, f32, i32, ptr,
            ],
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def kernel_info(kernel: str, dtype: torch.dtype, M: int, wide: bool, threads: int,
                smem: int) -> dict:
    """What the compiler made of one instantiation of `kernel` ("dual_oracle"
    or "dual_primal") and how many of its blocks are resident per SM."""
    out = (ctypes.c_int * 4)()
    rc = _fn(f"{kernel}_info")(_DTYPE_CODES[dtype], M, int(wide), threads, smem, out)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel attributes: CUDA error {rc}")
    return {"max_threads": out[0], "registers": out[1], "spill_bytes": out[2],
            "blocks_per_sm": out[3]}


def _require(ok: bool, msg: str, kernel: str = "dual_oracle") -> None:
    if not ok:
        raise ValueError(f"{kernel} kernel: {msg}")


def check_slab(kernel, idx, coeff, cost, mask, lam, J, coeff_scale, cost_scale):
    """Raises `ValueError` on what the slab kernels (the oracle and the
    primal step) do not take; returns whether the slab is int8.  `lam` may
    be None (a plan checks it per call)."""
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
    if lam is not None:
        _check_lam(kernel, lam, m * J, dev)
    quantized = dtype == torch.int8
    need(quantized == (coeff_scale is not None)
         and quantized == (cost_scale is not None),
         "int8 slabs need coeff_scale and cost_scale; float slabs take none")
    tensors = [idx, coeff, cost, mask]
    if quantized:
        need(coeff_scale.dtype == torch.float32 and coeff_scale.numel() == m
             and cost_scale.dtype == torch.float32 and cost_scale.numel() == 1,
             "scales must be fp32 [m, 1, 1] and [1, 1]")
        tensors += [coeff_scale, cost_scale]
    need(all(t.device == dev for t in tensors), "all tensors on one device")
    need(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    return quantized


def _check_lam(kernel: str, lam: torch.Tensor, mJ: int, dev: torch.device) -> None:
    _require(lam.dtype == torch.float32 and lam.numel() == mJ,
             f"lam must be fp32 with {mJ} entries", kernel)
    _require(lam.device == dev and lam.is_contiguous(),
             "lam must be contiguous on the slabs' device", kernel)


def fixed_point_shift(slabs: Sequence, J: int, radius: float) -> int:
    """The largest shift <= 100 with

        max_k max|coeff_k| (dequantized) * radius * (most slots of any bin)
            * 2^shift <= 2^62,

    counting the slots of nonzero mask of every slab in each destination's
    bin.  As 0 <= x <= radius, every fixed-point contribution, partial and
    total of A x then fits an int64.  One host sync (per plan)."""
    if not slabs:
        return MAX_SHIFT
    dev = slabs[0].cost.device
    counts = torch.zeros(J, dtype=torch.int64, device=dev)
    amax = torch.zeros((), dtype=torch.float32, device=dev)
    for s in slabs:
        if s.idx.numel() == 0:
            continue
        live = s.idx[s.mask != 0].long()
        counts = counts + torch.bincount(live, minlength=J)[:J]
        per_family = s.coeff.abs().amax(dim=(1, 2)).float()
        if s.coeff_scale is not None:
            per_family = per_family * s.coeff_scale.reshape(-1)
        amax = torch.maximum(amax, per_family.max())
    most, biggest = torch.stack([counts.max().double(), amax.double()]).tolist()
    bound = biggest * float(radius) * most
    if not math.isfinite(bound):
        raise ValueError(f"dual_oracle kernel: coefficient bound {bound} is not finite")
    if bound == 0.0:
        return MAX_SHIFT
    shift = min(MAX_SHIFT, math.floor(FIXED_POINT_BITS - math.log2(bound)))
    while bound * 2.0 ** shift > 2.0 ** FIXED_POINT_BITS:
        shift -= 1
    if shift < -MAX_SHIFT:
        raise ValueError(f"dual_oracle kernel: coefficients too large for the fixed-point "
                         f"A x (bound {bound})")
    return shift


def plan_slabs(
    kernel: str,
    slabs: Sequence,
    num_destinations: int,
    *,
    radius: float = 1.0,
    inequality: bool = True,
    grid: Optional[int] = None,
) -> SlabPlan:
    """The plan of `kernel` ("dual_oracle" or "dual_primal") over `slabs`
    (`Bucket`s or `Slab`s on one card, of kernel widths): checks, launches,
    layouts, grids and words, built once.  `grid` overrides the narrow
    launch's grid (tests of grid independence)."""
    if kernel not in ("dual_oracle", "dual_primal"):
        raise ValueError(f"no slab kernel {kernel!r}")
    if not slabs:
        raise ValueError(f"{kernel} kernel: a plan needs at least one slab")
    J = num_destinations
    first = slabs[0]
    m, dtype, dev = first.coeff.shape[0], first.cost.dtype, first.cost.device
    quantized = False
    for s in slabs:
        quantized = check_slab(kernel, s.idx, s.coeff, s.cost, s.mask, None, J,
                               s.coeff_scale, s.cost_scale)
        _require(s.coeff.shape[0] == m and s.cost.dtype == dtype and s.cost.device == dev,
                 "all slabs of a plan share m, dtype and device", kernel)
    M = family_template(m)
    shapes = tuple((int(s.cost.shape[0]), int(s.cost.shape[1])) for s in slabs)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    oracle = kernel == "dual_oracle"

    def sized(wide, ids, L, tasks):
        lay = (oracle_layout if oracle else primal_layout)(L, m, J)
        threads = 32 * lay.warps
        info = kernel_info(kernel, dtype, M, wide, threads, lay.smem_bytes)
        if info["blocks_per_sm"] < 1:
            raise ValueError(f"{kernel} kernel: no block of {threads} threads and "
                             f"{lay.smem_bytes} B fits on an SM")
        g = max(1, min(num_sms * info["blocks_per_sm"], _cdiv(tasks, lay.warps)))
        if grid is not None and not wide:
            g = grid
        return LaunchPlan(wide, tuple(ids), g, threads, lay, 0, tasks,
                          info["blocks_per_sm"], info["registers"], info["spill_bytes"])

    plans = []
    narrow = [i for i, (n, L) in enumerate(shapes) if L <= 32 and n > 0]
    for c in range(0, len(narrow), MAX_SLABS):
        ids = narrow[c:c + MAX_SLABS]
        _, tasks = narrow_tasks([shapes[i] for i in ids])
        plans.append(sized(False, ids, max(shapes[i][1] for i in ids), tasks))
    for i, (n, L) in enumerate(shapes):
        if L > 32 and n > 0:
            plans.append(sized(True, [i], L, n))
    scal_row, placed = 0, []  # one (c'x, ||x||^2) row per block of every launch
    for p in plans:
        placed.append(dataclasses.replace(p, scal_row=scal_row))
        scal_row += p.grid
    words = (ctypes.c_longlong * (SLAB_WORDS * len(slabs)))()
    task0 = {}
    for p in placed:
        if not p.wide:
            task0.update(zip(p.slabs, narrow_tasks([shapes[i] for i in p.slabs])[0]))
    for i, s in enumerate(slabs):
        n, L = shapes[i]
        w = [s.idx.data_ptr(), s.coeff.data_ptr(), s.cost.data_ptr(), s.mask.data_ptr(),
             s.coeff_scale.data_ptr() if quantized else 0,
             s.cost_scale.data_ptr() if quantized else 0,
             n, L, task0.get(i, 0), _scan_chunk(n, L) if L > 32 else L, 0, n]
        words[SLAB_WORDS * i:SLAB_WORDS * (i + 1)] = w
    lwords = (ctypes.c_longlong * (LAUNCH_WORDS * max(1, len(placed))))()
    for k, p in enumerate(placed):
        ids = list(p.slabs) + [0] * (MAX_SLABS - len(p.slabs))
        lwords[LAUNCH_WORDS * k:LAUNCH_WORDS * (k + 1)] = [
            int(p.wide), p.grid, p.threads, p.layout.smem_bytes, int(p.layout.lam_in_smem),
            p.layout.hist_mode, p.scal_row, p.tasks, len(p.slabs), *ids]
    mJ = m * J
    return SlabPlan(
        kernel=kernel, device=dev, m=m, J=J, M=M, dtype=dtype,
        out_dtype=torch.float32 if quantized else dtype, shapes=shapes,
        launches=tuple(placed), radius=float(radius), inequality=bool(inequality),
        shift=fixed_point_shift(slabs, J, radius) if oracle else 0,
        scal_rows=scal_row if oracle else 0,
        finalize_grid=max(1, min(_cdiv(mJ, FINALIZE_THREADS), 8 * num_sms)),
        slab_words=words, launch_words=lwords,
        slab_tensors=tuple((s.idx, s.coeff, s.cost, s.mask, s.coeff_scale, s.cost_scale)
                           for s in slabs),
    )


def plan_batched(
    slabs: Sequence,
    num_destinations: int,
    *,
    radius: float = 1.0,
    inequality: bool = True,
    grid: Optional[int] = None,
) -> SlabPlan:
    """The oracle's plan over B stacked instances of one shape (the tenant
    axis): `slabs` hold contiguous [B, ...] tensors (idx [B, n, L], coeff
    [B, m, n, L], cost and mask [B, n, L]; int8 scales [B, m, 1, 1] and
    [B, 1, 1]).  Lane 0's plan, launched with B lanes, and the fixed-point
    shift of every lane (one host sync per lane)."""
    _require(bool(slabs), "a plan needs at least one slab")
    lanes = int(slabs[0].cost.shape[0])
    for s in slabs:
        for t in (s.idx, s.coeff, s.cost, s.mask, s.coeff_scale, s.cost_scale):
            _require(t is None or (t.dim() >= 1 and t.shape[0] == lanes and t.is_contiguous()),
                     "stacked slabs must be contiguous with one leading lane dimension")
    from repro_torch.kernels.ref import lane_slab

    plan = plan_slabs("dual_oracle", [lane_slab(s, 0) for s in slabs], num_destinations,
                      radius=radius, inequality=inequality, grid=grid)
    shifts = tuple(
        fixed_point_shift([lane_slab(s, b) for s in slabs], num_destinations, radius)
        for b in range(lanes))
    q = torch.tensor([[2.0 ** k for k in shifts], [2.0 ** -k for k in shifts]],
                     dtype=torch.float32).to(plan.device)
    return dataclasses.replace(
        plan, lanes=lanes, lane_shifts=shifts, lane_q=q,
        slab_tensors=tuple((s.idx, s.coeff, s.cost, s.mask, s.coeff_scale, s.cost_scale)
                           for s in slabs))


def _outputs(plan: SlabPlan) -> tuple[tuple[torch.Tensor, ...], ctypes.Array]:
    """The x slabs of one call ([B, n, L] each over B lanes) and their
    pointers."""
    lead = (plan.lanes,) if plan.lanes else ()
    xs = tuple(torch.empty(lead + shape, dtype=plan.out_dtype, device=plan.device)
               for shape in plan.shapes)
    ptrs = (ctypes.c_longlong * max(1, len(xs)))(*[x.data_ptr() for x in xs])
    return xs, ptrs


def lane_inv_gamma(gamma: torch.Tensor, device) -> torch.Tensor:
    """Each lane's 1/gamma_b as fp32 on `device` ([B] contiguous):
    fp32(1) / fp32(gamma_b), correctly rounded, so lane b's value is
    `inv_gamma(gamma_b)` bit for bit (numpy's fp32 division on the host,
    PyTorch's IEEE fp32 reciprocal on the card)."""
    g = gamma.detach().to(torch.float32)
    if g.device.type == "cpu":
        inv = torch.from_numpy(np.float32(1.0) / g.numpy())
        return inv.to(device)
    return torch.reciprocal(g.to(device)).contiguous()


def oracle_call(
    plan: SlabPlan, lam: torch.Tensor, gamma, *, scratch: Optional[dict] = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor]:
    """One oracle call of a "dual_oracle" plan: `(x_slabs, ax, lin, sq)`.

    x_slabs in the storage dtype (fp32 for int8), ax [m*J] = A x, lin =
    c'x and sq = ||x||^2, all fp32.  Over B lanes (`plan_batched`) lam is
    [B, m*J] and the outputs gain the lane dimension: x [B, n, L] per
    bucket, ax [B, m*J], lin and sq [B]; `gamma` is then a float shared by
    the lanes or a [B] tensor, gamma_b per lane (the batched PDHG prox
    step), with lane b bitwise its solo call at gamma_b.  `scratch`, when
    given, receives the int64 row ("acc") and the per-block fp32 partials
    ("scal") the finalize read."""
    global launches, finalize_launches
    _require(plan.kernel == "dual_oracle", f"a {plan.kernel} plan")
    mJ, dev, batched = plan.m * plan.J, plan.device, plan.lanes > 0
    B = max(plan.lanes, 1)
    _check_lam("dual_oracle", lam, B * mJ, dev)
    _require(not batched or tuple(lam.shape) == (B, mJ), f"lam must be [{B}, {mJ}] over {B} lanes")
    ginv, ginv_lanes = 1.0, None
    if isinstance(gamma, torch.Tensor):
        _require(batched and tuple(gamma.shape) == (B,),
                 f"a per-lane gamma must be [{B}] on a plan of {B} lanes")
        ginv_lanes = lane_inv_gamma(gamma, dev)
    else:
        ginv = inv_gamma(gamma)
    xs, ptrs = _outputs(plan)
    work = torch.zeros(B * (mJ + plan.scal_rows), dtype=torch.int64, device=dev)
    res = torch.empty(B * (mJ + 2), dtype=torch.float32, device=dev)
    acc_ptr, res_ptr = work.data_ptr(), res.data_ptr()
    with torch.cuda.device(dev):
        rc = _fn("dual_oracle_run")(
            plan.slab_words, len(plan.shapes), plan.launch_words, len(plan.launches),
            _DTYPE_CODES[plan.dtype], plan.M, plan.m, plan.J, lam.data_ptr(), ptrs,
            acc_ptr, acc_ptr + 8 * B * mJ, plan.scal_rows, res_ptr, res_ptr + 4 * B * mJ,
            ginv, plan.radius, int(plan.inequality), plan.shift,
            plan.finalize_grid, B, 0 if plan.lane_q is None else plan.lane_q.data_ptr(),
            0 if ginv_lanes is None else ginv_lanes.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dual_oracle kernel launch failed: CUDA error {rc}")
    with _count_lock:
        launches += len(plan.launches)
        finalize_launches += 1
    if scratch is not None:
        scal = work[B * mJ:].view(torch.float32)
        scratch.update(acc=work[:B * mJ].view(B, mJ) if batched else work[:mJ],
                       scal=scal.reshape(B, plan.scal_rows, 2) if batched
                       else scal.reshape(plan.scal_rows, 2))
    if batched:
        lin_sq = res[B * mJ:].view(B, 2)
        return xs, res[:B * mJ].view(B, mJ), lin_sq[:, 0], lin_sq[:, 1]
    return xs, res[:mJ], res[mJ], res[mJ + 1]


def oracle_finalize(acc: torch.Tensor, scal: torch.Tensor, shift: int,
                    finalize_grid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The finalize kernel alone on the int64 row [m*J] and the per-block
    partials [rows, 2] an oracle call left: `(ax, lin_sq)`."""
    global finalize_launches
    dev = acc.device
    _require(acc.dtype == torch.int64 and acc.dim() == 1 and acc.is_contiguous()
             and scal.dtype == torch.float32 and scal.is_contiguous()
             and scal.device == dev and dev.type == "cuda",
             "finalize takes an int64 row and fp32 pairs on one card")
    ax = torch.empty(acc.shape[0], dtype=torch.float32, device=dev)
    lin_sq = torch.empty(2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _fn("dual_oracle_finalize")(
            acc.data_ptr(), acc.shape[0], scal.data_ptr(), scal.shape[0], shift,
            ax.data_ptr(), lin_sq.data_ptr(), finalize_grid,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dual_oracle finalize launch failed: CUDA error {rc}")
    with _count_lock:
        finalize_launches += 1
    return ax, lin_sq


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on one bucket, planned for this call: `(x, hist, lin, sq)`.

    x [n, L] is in the storage dtype (fp32 for int8); hist [m, J] is this
    bucket's A x, lin = c'x and sq = ||x||^2, all fp32.
    """
    quantized = check_slab("dual_oracle", idx, coeff, cost, mask, lam, num_destinations,
                           coeff_scale, cost_scale)
    slab = Slab(idx, coeff, cost, mask, coeff_scale if quantized else None,
                cost_scale if quantized else None)
    plan = plan_slabs("dual_oracle", [slab], num_destinations, radius=radius,
                      inequality=inequality)
    (x,), ax, lin, sq = oracle_call(plan, lam, gamma)
    return x, ax.reshape(coeff.shape[0], num_destinations), lin, sq
