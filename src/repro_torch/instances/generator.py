"""Synthetic matching-LP generator — faithful to the paper's Appendix A.

Construction (Appendix A, "Synthetic LP construction"):

1. Draw a lognormal "breadth" parameter beta_j per resource (destination) j,
   normalise to probabilities p_j, and sample the number of incident requests
   K_j ~ Poisson(p_j * I * nu), truncated at I, where nu is the desired average
   number of nonzeros per row.
2. For each resource j, select K_j distinct requests i and create edges (i, j).
3. On each edge draw a resource value scale v_j, a request responsiveness u_i,
   multiplicative noise eps_ij, and set  c_ij = min(v_j * u_i * eps_ij, c_max).
4. Constraint coefficients a_ij = s_j * c_ij with lognormal per-resource s_j.
5. RHS: greedy load l_j = sum over requests of their single largest incident
   a_ij (assigned to that resource), then b_j = rho_j * (l_j + eps) with
   rho_j ~ U[0.5, 1.0].

Signs are adjusted to the minimisation convention: the solver receives
c = -value so that minimising c'x maximises matched value.

Generation is host-side numpy (this is the data pipeline, not the solver); the
output is an edge list that `buckets.bucketize` packs into bucketed-ELL slabs.
This module is a line-for-line copy of `repro.instances.generator`: the same
spec and seed give the same edge list in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "MatchingInstanceSpec",
    "EdgeListInstance",
    "generate_matching_instance",
]


@dataclasses.dataclass(frozen=True)
class MatchingInstanceSpec:
    """Parameters of the Appendix-A synthetic generator."""

    num_sources: int  # I  (requests / users)
    num_destinations: int  # J  (resources / items)
    avg_degree: float = 10.0  # nu: average eligible destinations per source
    num_families: int = 1  # m: coupling-constraint families (Def. 1)
    breadth_sigma: float = 1.0  # lognormal sigma of resource breadth
    value_sigma: float = 0.5  # lognormal sigma of v_j
    responsiveness_sigma: float = 0.5  # lognormal sigma of u_i
    noise_sigma: float = 0.25  # lognormal sigma of eps_ij
    scale_sigma: float = 0.5  # lognormal sigma of s_j (a_ij = s_j c_ij)
    c_max: float = 10.0
    rhs_eps: float = 1e-3
    seed: int = 0

    def __post_init__(self) -> None:
        if self.num_sources <= 0 or self.num_destinations <= 0:
            raise ValueError("num_sources/num_destinations must be positive")
        if self.num_families < 1:
            raise ValueError("need at least one coupling family")


@dataclasses.dataclass
class EdgeListInstance:
    """Edge-list form of a matching LP (host-side, pre-packing).

    Edges are sorted by (source, destination).  ``values`` holds the *positive*
    matched value; ``cost`` = -values is what the solver minimises.  ``coeff``
    has shape [m, nnz]: constraint coefficients per family.  ``rhs`` has shape
    [m * J] in family-major order (row r = k * J + j).
    """

    spec: MatchingInstanceSpec
    src: np.ndarray  # [nnz] int64 source ids
    dst: np.ndarray  # [nnz] int64 destination ids
    values: np.ndarray  # [nnz] f64 positive values
    coeff: np.ndarray  # [m, nnz] f64 constraint coefficients
    rhs: np.ndarray  # [m * J] f64

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])

    @property
    def cost(self) -> np.ndarray:
        return -self.values

    def degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.spec.num_sources)

    def to_dense(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialise (A, b, c) densely — tests/small instances only.

        A: [m*J, I*J] with the Def.-1 diagonal block structure, x stacked
        source-major (x_ij at column i*J + j).
        """
        spec = self.spec
        I, J, m = spec.num_sources, spec.num_destinations, spec.num_families
        if I * J > 4_000_000:
            raise ValueError("to_dense() is for small test instances only")
        A = np.zeros((m * J, I * J))
        c = np.zeros(I * J)
        cols = self.src * J + self.dst
        c[cols] = self.cost
        for k in range(m):
            A[k * J + self.dst, cols] = self.coeff[k]
        return A, self.rhs.copy(), c


def _lognormal(rng: np.random.Generator, sigma: float, size) -> np.ndarray:
    # mean-1 lognormal: exp(N(-sigma^2/2, sigma^2))
    return rng.lognormal(mean=-0.5 * sigma * sigma, sigma=sigma, size=size)


def generate_matching_instance(spec: MatchingInstanceSpec) -> EdgeListInstance:
    """Generate an Appendix-A synthetic matching LP as an edge list."""
    rng = np.random.default_rng(spec.seed)
    I, J, m = spec.num_sources, spec.num_destinations, spec.num_families

    # --- 1. bipartite graph: resource breadth -> Poisson degrees ------------
    breadth = _lognormal(rng, spec.breadth_sigma, J)
    p = breadth / breadth.sum()
    K = np.minimum(rng.poisson(p * I * spec.avg_degree), I)  # [J], truncated at I

    # For each resource j select K_j distinct requests.  Vectorised: draw all
    # (request, resource) pairs then dedupe; re-draw collisions cheaply by
    # sampling with replacement and dropping duplicates (the collision rate is
    # negligible at production sparsity; any shortfall only perturbs K_j which
    # is itself random).
    dst = np.repeat(np.arange(J, dtype=np.int64), K)
    src = rng.integers(0, I, size=dst.shape[0], dtype=np.int64)
    if dst.size == 0:  # degenerate tiny instance: keep at least one edge
        src = np.zeros(1, dtype=np.int64)
        dst = np.asarray([int(np.argmax(p))], dtype=np.int64)
    eid = src * J + dst
    _, keep = np.unique(eid, return_index=True)
    src, dst = src[keep], dst[keep]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    nnz = src.shape[0]

    # --- 2. edge values ------------------------------------------------------
    v = _lognormal(rng, spec.value_sigma, J)  # per-resource value scale
    u = _lognormal(rng, spec.responsiveness_sigma, I)  # per-request factor
    eps = _lognormal(rng, spec.noise_sigma, nnz)
    values = np.minimum(v[dst] * u[src] * eps, spec.c_max)

    # --- 3. constraint coefficients per family -------------------------------
    coeff = np.empty((m, nnz))
    for k in range(m):
        s = _lognormal(rng, spec.scale_sigma, J)
        coeff[k] = s[dst] * values

    # --- 4. greedy-load RHS ---------------------------------------------------
    rhs = np.empty(m * J)
    for k in range(m):
        # per request: largest incident a_ij -> assign to that resource.
        # Vectorised segmented argmax: sort edges by (src, -a); the first edge
        # of each source segment is its greedy winner.
        a = coeff[k]
        order_k = np.lexsort((-a, src))
        first_pos = np.unique(src[order_k], return_index=True)[1]
        winners = order_k[first_pos]
        load = np.zeros(J)
        np.add.at(load, dst[winners], a[winners])
        rho = rng.uniform(0.5, 1.0, size=J)
        rhs[k * J : (k + 1) * J] = rho * (load + spec.rhs_eps)

    return EdgeListInstance(
        spec=spec, src=src, dst=dst, values=values, coeff=coeff, rhs=rhs
    )
