"""The benchmark's own inputs: the paper's Appendix-A instance generator and a
pool of cadence deltas, both drawn from `--seed`.

The instance generator is the Appendix-A construction (as
`repro_torch.instances.generator` implements it with numpy), kept here so
that a later change to the program cannot change what the benchmark feeds it,
and drawn on the card with a `torch.Generator` in a few large calls: the same
parameters, seed and device give the same edge list.  The delta pool is
vectorised numpy: every delta of a run is made in set-up, each against the
edge set the deltas before it leave, so the window only ingests.

Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Edges", "Delta", "generate", "delta_pool", "rng_for"]


@dataclasses.dataclass
class Edges:
    """An edge list sorted by (source, destination): positive `values`
    (cost = -values), `coeff` [m, nnz] and `rhs` [m * J] family-major."""

    num_sources: int
    num_destinations: int
    num_families: int
    src: np.ndarray  # [nnz] int64
    dst: np.ndarray  # [nnz] int64
    values: np.ndarray  # [nnz] float64
    coeff: np.ndarray  # [m, nnz] float64
    rhs: np.ndarray  # [m * J] float64

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])


@dataclasses.dataclass
class Delta:
    """One cadence's edits: the fields of the program's `InstanceDelta`."""

    insert_src: np.ndarray
    insert_dst: np.ndarray
    insert_values: np.ndarray
    insert_coeff: np.ndarray  # [m, k]
    delete_src: np.ndarray
    delete_dst: np.ndarray
    update_src: np.ndarray
    update_dst: np.ndarray
    update_values: np.ndarray
    rhs: np.ndarray


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent host generator per use of one seed (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def _torch_generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator on `device` per use of one seed (any
    integer): the same seed, stream and device give the same draws."""
    state = np.random.SeedSequence([int(seed) % (1 << 63), stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


def _lognormal(gen: torch.Generator, sigma: float, size: int, device) -> torch.Tensor:
    # mean-1 lognormal: exp(N(-sigma^2/2, sigma^2))
    out = torch.empty(size, dtype=torch.float64, device=device)
    return out.log_normal_(mean=-0.5 * sigma * sigma, std=sigma, generator=gen)


def generate(cfg: dict, seed: int, device="cpu") -> Edges:
    """Appendix A, drawn on `device` in a few large calls: lognormal resource
    breadth, Poisson degrees truncated at I, distinct (request, resource)
    pairs, c_ij = min(v_j u_i eps_ij, c_max), a_ij = s_j c_ij per family, and
    b_j = rho_j (greedy load_j + eps).  Returned on the host."""
    gen = _torch_generator(seed, 0, device)
    I, J = int(cfg["num_sources"]), int(cfg["num_destinations"])
    m, nu = int(cfg["num_families"]), float(cfg["avg_degree"])
    lognormal = lambda sigma, size: _lognormal(gen, sigma, size, device)

    breadth = lognormal(cfg["breadth_sigma"], J)
    p = breadth / breadth.sum()
    K = torch.poisson(p * I * nu, generator=gen).clamp_max(I).long()
    dst = torch.repeat_interleave(torch.arange(J, device=device), K)
    src = torch.randint(0, I, (dst.numel(),), generator=gen, device=device)
    if dst.numel() == 0:
        src = torch.zeros(1, dtype=torch.int64, device=device)
        dst = torch.argmax(p).reshape(1)
    keys = torch.unique(src * J + dst)  # sorted by (source, destination)
    src, dst = keys // J, keys % J
    nnz = keys.numel()
    del keys

    v = lognormal(cfg["value_sigma"], J)
    u = lognormal(cfg["responsiveness_sigma"], I)
    values = torch.clamp_max(v[dst] * u[src] * lognormal(cfg["noise_sigma"], nnz),
                             cfg["c_max"])
    coeff = torch.stack([lognormal(cfg["scale_sigma"], J)[dst] * values for _ in range(m)])

    # each source's greedy winner: its first edge of largest a_ij, summed per
    # destination on the host in source order (fixed, unlike atomic adds)
    pos = torch.arange(nnz, device=device)
    rhs = []
    for k in range(m):
        a = coeff[k]
        top = torch.full((I,), -torch.inf, dtype=a.dtype, device=device)
        top = top.scatter_reduce(0, src, a, "amax")
        first = torch.full((I,), nnz, dtype=torch.int64, device=device)
        win = first.scatter_reduce(0, src, torch.where(a == top[src], pos, nnz), "amin")
        win = win[win < nnz]
        load = np.bincount(dst[win].cpu().numpy(), weights=a[win].cpu().numpy(), minlength=J)
        rho = torch.empty(J, dtype=torch.float64, device=device).uniform_(0.5, 1.0, generator=gen)
        rhs.append(rho.cpu().numpy() * (load + cfg["rhs_eps"]))
    host = lambda t: t.cpu().numpy()
    return Edges(I, J, m, host(src), host(dst), host(values), host(coeff), np.concatenate(rhs))


def _distinct(rng: np.random.Generator, n: int, k: int, ok) -> np.ndarray:
    """k distinct integers in [0, n) for which `ok` holds, in random order."""
    out = np.empty(0, np.int64)
    while out.size < k:
        cand = rng.integers(0, n, size=int((k - out.size) * 1.1) + 8)
        cand = cand[ok(cand)]
        out = np.concatenate([out, cand])
        _, first = np.unique(out, return_index=True)
        out = out[np.sort(first)]
    return out[:k]


def delta_pool(edges: Edges, traffic: dict, seed: int, count: int) -> list[Delta]:
    """`count` deltas in sequence, each drawn against the edge set that the
    deltas before it leave: value updates of `update_share` of the edges
    (each value times U[1 - value_jitter, 1 + value_jitter]), `inserts` new
    edges (value U[0.1, 3], coefficients U[0.1, 2]), `deletes` deleted edges,
    and the rhs times U[1 - rhs_jitter, 1 + rhs_jitter].  Updates and deletes
    draw from the generated edges still present; inserts from pairs absent."""
    rng = rng_for(seed, 1)
    I, J, m = edges.num_sources, edges.num_destinations, edges.num_families
    nnz = edges.nnz
    keys = edges.src * J + edges.dst  # sorted, as the edge list is
    alive = np.ones(nnz, bool)
    values = edges.values.copy()
    inserted: set[int] = set()
    rhs = edges.rhs.copy()
    n_upd = max(1, int(traffic["update_share"] * nnz))
    n_ins, n_del = int(traffic["inserts"]), int(traffic["deletes"])
    jitter, rhs_jitter = traffic["value_jitter"], traffic["rhs_jitter"]

    def absent(cand):
        pos = np.minimum(np.searchsorted(keys, cand), nnz - 1)
        present = (keys[pos] == cand) & alive[pos]
        return ~present & np.asarray([c not in inserted for c in cand.tolist()], bool)

    pool = []
    for _ in range(count):
        pick = _distinct(rng, nnz, n_upd + n_del, lambda c: alive[c])
        upd, dele = pick[:n_upd], pick[n_upd:]
        values[upd] *= rng.uniform(1 - jitter, 1 + jitter, n_upd)
        alive[dele] = False
        new = _distinct(rng, I * J, n_ins, absent)
        inserted.update(new.tolist())
        rhs = rhs * rng.uniform(1 - rhs_jitter, 1 + rhs_jitter, m * J)
        pool.append(Delta(
            insert_src=new // J, insert_dst=new % J,
            insert_values=rng.uniform(0.1, 3.0, n_ins),
            insert_coeff=rng.uniform(0.1, 2.0, (m, n_ins)),
            delete_src=edges.src[dele], delete_dst=edges.dst[dele],
            update_src=edges.src[upd], update_dst=edges.dst[upd],
            update_values=values[upd].copy(), rhs=rhs.copy(),
        ))
    return pool
