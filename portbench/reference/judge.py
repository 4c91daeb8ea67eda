"""The numbers that decide `correct`: the program's outputs, handed over as
plain tensors, against the float64 reference.

The program's packed instance is read slot by slot: each slab row is the
source that the program's own row map names, and each live slot the edge
(source, slot's destination id).  Every source of the reference must appear
once, with exactly its edges; a live slot in a row the map does not name, or
a value left in a padding slot, counts against the program too.
"""
from __future__ import annotations

import torch

from portbench.reference.matching import RefInstance

__all__ = ["ProgramSlabs", "edges_of", "slab_numbers", "rel_l2", "x_gap", "rel_gap"]


class ProgramSlabs:
    """Per bucket: ids [n, L], cost [n, L], coeff [m, n, L], mask [n, L],
    the source of each row [n] (-1: no source), optionally x [n, L]."""

    def __init__(self, buckets, sources, xs=None):
        self.buckets, self.sources, self.xs = buckets, sources, xs


def edges_of(p: ProgramSlabs, J: int, device):
    """The program's live slots as edges sorted by key = source * J + dst:
    (keys, cost, coeff [m, k], x or None, stray), stray counting live slots
    in unnamed rows and nonzero values in padding slots."""
    keys, cost, coeff, xs, stray = [], [], [], [], 0
    for t, b in enumerate(p.buckets):
        idx, mask = b["idx"].to(device).long(), b["mask"].to(device).double()
        c, a = b["cost"].to(device).double(), b["coeff"].to(device).double()
        sid = p.sources[t].to(device).long()
        named = (sid >= 0)[:, None].expand_as(mask)
        live = (mask != 0) & named
        stray += int(((mask != 0) & ~named).sum())
        pad = mask == 0
        stray += int(((c != 0) & pad).sum()) + int(((a != 0) & pad[None]).sum())
        stray += int(((mask != 0) & (mask != 1)).sum())
        keys.append((sid[:, None].expand_as(idx) * J + idx)[live])
        cost.append(c[live])
        coeff.append(a[:, live])
        if p.xs is not None:
            xs.append(p.xs[t].to(device).double()[live])
    keys = torch.cat(keys)
    order = torch.argsort(keys)
    x = torch.cat(xs)[order] if p.xs is not None else None
    return keys[order], torch.cat(cost)[order], torch.cat(coeff, 1)[:, order], x, stray


def slab_numbers(p: ProgramSlabs, ref: RefInstance, rhs: torch.Tensor, *,
                 width: torch.dtype, exact: bool):
    """(mismatch, value_gap, x in reference edge order or None).

    mismatch counts edges present on one side only, stray slots, and, when
    `exact`, every cost, coefficient and rhs entry that differs from the
    reference's rounded to `width`, the slab dtype that the configuration
    states; otherwise costs exactly and the coefficients and rhs by
    `value_gap`, their largest relative gap."""
    dev = ref.src.device
    keys, cost, coeff, x, stray = edges_of(p, ref.J, dev)
    rkeys = ref.src * ref.J + ref.dst
    if keys.numel() != rkeys.numel() or not torch.equal(keys, rkeys):
        common = torch.isin(keys, rkeys)
        return int((~common).sum()) + int((~torch.isin(rkeys, keys)).sum()) + stray, \
            float("inf"), None
    as_slab = lambda t: t.to(width).double()
    mismatch = stray + int((cost != as_slab(ref.cost)).sum())
    rhs = rhs.to(dev).double()
    if exact:
        mismatch += int((coeff != as_slab(ref.coeff)).sum())
        mismatch += int((rhs != as_slab(ref.rhs)).sum())
        gap = 0.0
    else:
        gap = max(rel_gap(coeff, ref.coeff), rel_gap(rhs, ref.rhs))
    return mismatch, gap, x


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / |want| over the entries with want != 0, and
    inf where want == 0 and got is not."""
    got, want = got.double(), want.double()
    nz = want != 0
    if bool((got[~nz] != 0).any()):
        return float("inf")
    if not bool(nz.any()):
        return 0.0
    return float(((got[nz] - want[nz]).abs() / want[nz].abs()).max())


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().to(want.device), want.double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want).clamp_min(1e-300))


def x_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |x - x_ref| over the edges (x lies in [0, 1])."""
    return float((got.double().to(want.device) - want).abs().max())
