"""Python wrapper of the hand-written Hopper primal-step kernel (csrc/dual_primal.cu).

Replaces the Pallas kernel `repro/kernels/dual_primal.py::dual_primal_kernel_body`
for CUDA tensors: x = Pi_simplex(-(A^T lam + c) / gamma) for every bucket
of an objective, with x as the only output.  The plan is the oracle's
(`dual_oracle.plan_slabs` with kernel "dual_primal"): built once per
objective, it checks the slabs, puts every bucket of width <= 32 in one
launch (wider buckets one launch each), stages lam in shared memory when it
fits beside the wide rows' scratch (else lam is read through L1/L2, so no
instance is too large), and sizes the persistent grid with the occupancy
API.  `primal_call` allocates the x slabs, launches on the current stream
and counts each launch in `launches`; `dual_primal` is the single-bucket
call of the sweeps and the per-bucket times.

The row-list form (`plan_rows`, `rows_call`) is the serving query: x for a
list of requested rows of each bucket, output row r read from source row
rows[r], so a query reads O(q * L) slots.  Its plan is built once per
published snapshot (the slab pointers are fixed); a call copies the row
lists to the card in one transfer and makes one `rows_narrow` launch for
every requested bucket of width <= 32 (one more per wider bucket).  x comes
back in fp32 for fp32 and bf16 slabs alike, with each slot's mask and idx,
all in one output buffer.  Every launch, of either form, counts in
`launches`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.objective import inv_gamma
from repro_torch.kernels.dual_oracle import (
    _DTYPE_CODES,
    LAUNCH_WORDS,
    MAX_FUSED_LENGTH,
    MAX_SLABS,
    SLAB_WORDS,
    Slab,
    SlabPlan,
    _cdiv,
    _check_lam,
    _fn,
    _outputs,
    _primal_smem,
    _require,
    _scan_chunk,
    _widest,
    check_slab,
    family_template,
    narrow_tasks,
    plan_slabs,
)

__all__ = ["RowsPlan", "dual_primal", "launches", "plan_rows", "primal_call", "rows_call"]

launches = 0  # kernel launches since import (reset freely by callers)
_count_lock = threading.Lock()  # queries launch from several threads


def primal_call(plan: SlabPlan, lam: torch.Tensor, gamma: float) -> tuple[torch.Tensor, ...]:
    """One primal call of a "dual_primal" plan: the x slabs in the storage
    dtype (fp32 for int8)."""
    global launches
    _require(plan.kernel == "dual_primal", f"a {plan.kernel} plan", "dual_primal")
    dev = plan.device
    _check_lam("dual_primal", lam, plan.m * plan.J, dev)
    xs, ptrs = _outputs(plan)
    with torch.cuda.device(dev):
        rc = _fn("dual_primal_run")(
            plan.slab_words, len(plan.shapes), plan.launch_words, len(plan.launches),
            _DTYPE_CODES[plan.dtype], plan.M, plan.m, plan.J, lam.data_ptr(), ptrs,
            inv_gamma(gamma), plan.radius, int(plan.inequality),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dual_primal kernel launch failed: CUDA error {rc}")
    with _count_lock:
        launches += len(plan.launches)
    return tuple(xs)


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
    """The kernel on one bucket, planned for this call: x [n, L] in the
    storage dtype (fp32 for int8)."""
    quantized = check_slab("dual_primal", idx, coeff, cost, mask, lam, num_destinations,
                           coeff_scale, cost_scale)
    slab = Slab(idx, coeff, cost, mask, coeff_scale if quantized else None,
                cost_scale if quantized else None)
    plan = plan_slabs("dual_primal", [slab], num_destinations, radius=radius,
                      inequality=inequality)
    return primal_call(plan, lam, gamma)[0]


@dataclasses.dataclass(frozen=True, eq=False)
class _RowsSlab:
    """One bucket of a row-list plan: its slab words with no rows yet, and
    how its kernel runs."""

    words: tuple[int, ...]  # SLAB_WORDS int64 (n and the row list set per call)
    n: int  # rows of the source slab
    L: int
    threads: int
    smem: int
    blocks_per_sm: int


@dataclasses.dataclass(frozen=True, eq=False)
class RowsPlan:
    """The row-list kernel over every bucket of one instance (one snapshot)."""

    device: torch.device
    m: int
    J: int
    M: int
    dtype: torch.dtype
    num_sms: int
    radius: float
    inequality: bool
    slabs: tuple[Optional[_RowsSlab], ...]  # per bucket; None: not a kernel width
    slab_tensors: tuple  # keeps the slabs the words point into alive


def _rows_info(dtype, M, wide, threads, smem) -> dict:
    out = (ctypes.c_int * 4)()
    rc = _fn("dual_primal_rows_info")(_DTYPE_CODES[dtype], M, int(wide), threads, smem, out)
    if rc != 0:
        raise RuntimeError(f"dual_primal rows kernel attributes: CUDA error {rc}")
    return {"registers": out[1], "spill_bytes": out[2], "blocks_per_sm": out[3]}


def plan_rows(slabs: Sequence, num_destinations: int, *, radius: float = 1.0,
              inequality: bool = True) -> RowsPlan:
    """The row-list plan over `slabs` (every bucket of an instance, fp32 or
    bf16, of kernel widths), built once per snapshot on the card: checks,
    words and occupancy.  lam is read through L1/L2 (a query touches few
    rows, so staging lam per block would cost more than it saves)."""
    J = num_destinations
    first = slabs[0]
    m, dtype, dev = first.coeff.shape[0], first.cost.dtype, first.cost.device
    need = lambda ok, msg: _require(ok, msg, "dual_primal")
    need(dtype in (torch.float32, torch.bfloat16), f"row lists take fp32 or bf16 slabs, got {dtype}")
    M = family_template(m)
    out = []
    for s in slabs:
        n, L = (int(d) for d in s.cost.shape)
        if L & (L - 1) or L > MAX_FUSED_LENGTH:  # the width rule: the plain version
            out.append(None)
            continue
        check_slab("dual_primal", s.idx, s.coeff, s.cost, s.mask, None, J, None, None)
        need(s.coeff.shape[0] == m and s.cost.dtype == dtype and s.cost.device == dev,
             "all slabs of a plan share m, dtype and device")
        wide = L > 32
        warps = _widest(lambda w: _primal_smem(m * J, False, w, L) <= 232_448, L, M)
        smem = _primal_smem(m * J, False, warps, L)
        info = _rows_info(dtype, M, wide, 32 * warps, smem)
        need(info["blocks_per_sm"] >= 1, f"no block of {32 * warps} threads fits on an SM")
        words = (s.idx.data_ptr(), s.coeff.data_ptr(), s.cost.data_ptr(), s.mask.data_ptr(),
                 0, 0, n, L, 0, _scan_chunk(n, L) if wide else L, 0, n)
        out.append(_RowsSlab(words, n, L, 32 * warps, smem, info["blocks_per_sm"]))
    return RowsPlan(
        device=dev, m=m, J=J, M=M, dtype=dtype,
        num_sms=torch.cuda.get_device_properties(dev).multi_processor_count,
        radius=float(radius), inequality=bool(inequality), slabs=tuple(out),
        slab_tensors=tuple((s.idx, s.coeff, s.cost, s.mask) for s in slabs),
    )


def rows_call(
    plan: RowsPlan, lam: torch.Tensor, gamma: float, requests: Sequence[tuple[int, np.ndarray]],
) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """x of the requested rows: `requests` is [(bucket, rows int64 [q])];
    returns, per request, `(x [q, L] fp32, mask [q, L] fp32, idx [q, L]
    int32)`, views of one output buffer on the card.  One host-to-card copy
    of every row list, one launch for the requested buckets of width <= 32
    (up to 16 per launch) and one per wider bucket; nothing waits for the
    card."""
    global launches
    dev = plan.device
    _check_lam("dual_primal", lam, plan.m * plan.J, dev)
    asked = [(int(t), np.asarray(r, np.int64).reshape(-1)) for t, r in requests]
    for t, r in asked:
        _require(0 <= t < len(plan.slabs) and plan.slabs[t] is not None,
                 f"no kernel-width bucket {t}", "dual_primal")
        _require(r.size == 0 or (int(r.min()) >= 0 and int(r.max()) < plan.slabs[t].n),
                 f"rows of bucket {t} outside [0, {plan.slabs[t].n})", "dual_primal")
    plane = int(sum(r.size * plan.slabs[t].L for t, r in asked))
    buf = torch.empty(3 * max(plane, 1), dtype=torch.float32, device=dev)
    out, xoff = [], 0
    for t, r in asked:
        q, L = r.size, plan.slabs[t].L
        k = q * L
        out.append((buf[xoff:xoff + k].view(q, L), buf[plane + xoff:plane + xoff + k].view(q, L),
                    buf[2 * plane + xoff:2 * plane + xoff + k].view(torch.int32).view(q, L)))
        xoff += k
    # the requests with rows, each with where its x starts in the buffer
    reqs, xoff = [], 0
    for t, r in asked:
        if r.size:
            reqs.append((t, r, xoff))
        xoff += r.size * plan.slabs[t].L
    if not reqs:
        return out
    counts = [r.size for _, r, _ in reqs]
    rows = torch.from_numpy(np.concatenate([r for _, r, _ in reqs])).to(dev)
    words = (ctypes.c_longlong * (SLAB_WORDS * len(reqs)))()
    xptrs = (ctypes.c_longlong * len(reqs))()
    narrow = [i for i, (t, _, _) in enumerate(reqs) if plan.slabs[t].L <= 32]
    task0 = {}
    groups = [narrow[c:c + MAX_SLABS] for c in range(0, len(narrow), MAX_SLABS)]
    for g in groups:
        starts, _ = narrow_tasks([(counts[i], plan.slabs[reqs[i][0]].L) for i in g])
        task0.update(zip(g, starts))
    roff = 0
    for i, ((t, _, x0), q) in enumerate(zip(reqs, counts)):
        w = list(plan.slabs[t].words)
        w[6], w[8], w[10] = q, task0.get(i, 0), rows.data_ptr() + 8 * roff
        words[SLAB_WORDS * i:SLAB_WORDS * (i + 1)] = w
        xptrs[i] = buf.data_ptr() + 4 * x0
        roff += q
    launch_rows = []
    for g in groups:
        _, tasks = narrow_tasks([(counts[i], plan.slabs[reqs[i][0]].L) for i in g])
        s = plan.slabs[reqs[g[0]][0]]  # every narrow block is the same
        launch_rows.append((0, g, tasks, s))
    for i, (t, _, _) in enumerate(reqs):
        if plan.slabs[t].L > 32:
            launch_rows.append((1, [i], counts[i], plan.slabs[t]))
    lwords = (ctypes.c_longlong * (LAUNCH_WORDS * len(launch_rows)))()
    for k, (wide, ids, tasks, s) in enumerate(launch_rows):
        warps = s.threads // 32
        grid = max(1, min(plan.num_sms * s.blocks_per_sm, _cdiv(tasks, warps)))
        smem = max(plan.slabs[reqs[i][0]].smem for i in ids)
        lwords[LAUNCH_WORDS * k:LAUNCH_WORDS * (k + 1)] = [
            wide, grid, s.threads, smem, 0, 0, 0, tasks, len(ids),
            *(list(ids) + [0] * (MAX_SLABS - len(ids)))]
    with torch.cuda.device(dev):
        rc = _fn("dual_primal_rows_run")(
            words, len(reqs), lwords, len(launch_rows), _DTYPE_CODES[plan.dtype], plan.M,
            plan.m, plan.J, lam.data_ptr(), xptrs, plane, inv_gamma(gamma), plan.radius,
            int(plan.inequality), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dual_primal rows kernel launch failed: CUDA error {rc}")
    with _count_lock:
        launches += len(launch_rows)
    return out
