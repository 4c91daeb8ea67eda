"""ObjectiveFunction — the dual oracle (port of `repro.core.objective`).

`MatchingObjective.calculate(lam, gamma)` returns (g(lam), grad g(lam), x*(lam))
for the ridge-regularized matching LP:

    x*_gamma(lam) = Pi_C( -(A^T lam + c) / gamma )          (eq. 3)
    grad g(lam)   = A x*_gamma(lam) - b                      (eq. 4)
    g(lam)        = c'x* + (gamma/2)||x*||^2 + lam'(A x* - b)

over the bucketed-ELL layout: A^T lam is a per-bucket gather, A x a
per-bucket sum into J bins per family, in a fixed order (`binned_segment_sum`).  `fused_oracle=True` routes
the whole of `calculate` through the one-pass fused dual oracle
(`kernels.ops.fused_dual_oracle`): per bucket, one kernel launch emits the
primal slab, the A x histogram and (c'x, ||x||^2) from a single slab read.
`fused_kernel=True` routes only the primal step through the fused primal
kernel (`kernels.ops.fused_dual_primal`); A x and the objective terms stay
on the plain path.

The formulation layer of the reference (a `FormulationSpec` on the instance,
non-unit term scales) is not part of this port yet; `repro_torch.convert`
refuses an instance that carries one.  `gamma` is a Python float throughout,
so no call here waits for the device, apart from the first A x of an
objective, which sorts each bucket's bins once (`segment_plans`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.projections import ProjectionMap, UnitSimplexProjection
from repro_torch.instances.buckets import (
    Bucket,
    BucketedInstance,
    _host,
    _quantize_sym,
    dequantize_bucket,
)

__all__ = [
    "DualEval",
    "MatchingObjective",
    "SegmentPlan",
    "binned_segment_sum",
    "gather_at_lam",
    "inv_gamma",
    "normalize_rows",
    "segment_plan",
    "start_vector",
]


class DualEval(NamedTuple):
    g: torch.Tensor  # scalar dual objective g(lam)
    grad: torch.Tensor  # [m*J] gradient of g
    x_slabs: tuple[torch.Tensor, ...]  # per-bucket primal slabs
    primal_linear: torch.Tensor  # c'x
    primal_ridge: torch.Tensor  # (gamma/2)||x||^2
    ax: torch.Tensor  # [m*J] A x


def _acc32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def gather_at_lam(coeff: torch.Tensor, idx: torch.Tensor, lam2: torch.Tensor) -> torch.Tensor:
    """(A^T lam) restricted to one bucket: [n, L].  The family products are
    summed in family order, as the dual-oracle kernel sums them."""
    gathered = lam2[:, idx.long()]  # [m, n, L]
    atl = coeff[0] * gathered[0]
    for k in range(1, coeff.shape[0]):
        atl = atl + coeff[k] * gathered[k]
    return atl


def inv_gamma(gamma: float) -> float:
    """1/gamma rounded to fp32.  The primal candidate is -(A^T lam + c) times
    this, on every path: it is what the kernel takes and what PyTorch's CUDA
    division by a Python scalar computes."""
    return float(np.float32(1.0) / np.float32(gamma))


class SegmentPlan(NamedTuple):
    """The fixed order in which `binned_segment_sum` adds one slab's slots."""

    order: torch.Tensor  # [m*n*L] int64: the slots sorted by bin, stably
    offsets: torch.Tensor  # [m*J + 1] int64: where each bin starts in `order`


def segment_plan(idx: torch.Tensor, m: int, J: int) -> SegmentPlan:
    """Sort the family-offset bins (idx + k*J) of one slab once."""
    offs = torch.arange(m, device=idx.device, dtype=torch.int64)[:, None] * J
    seg = (idx.reshape(1, -1).long() + offs).reshape(-1)
    counts = torch.bincount(seg, minlength=m * J)
    return SegmentPlan(torch.argsort(seg, stable=True),
                       torch.cat([counts.new_zeros(1), counts.cumsum(0)]))


def binned_segment_sum(
    idx: torch.Tensor, contrib: torch.Tensor, J: int, plan: SegmentPlan | None = None
) -> torch.Tensor:
    """Sum [m, ...] contributions into [m, J] bins keyed by `idx`.

    The contributions are put in the plan's order (bins ascending, slots
    ascending within a bin) and reduced per bin by `segment_reduce`, so the
    sums are the same in every run on a device: no float atomics.  On
    the CPU they are bitwise those of `index_add_` in slot order.  The plan
    is computed here when none is given (`segment_plan`).
    """
    m = contrib.shape[0]
    if plan is None:
        plan = segment_plan(idx, m, J)
    ordered = torch.index_select(contrib.reshape(-1), 0, plan.order)
    out = torch.segment_reduce(ordered, "sum", offsets=plan.offsets, unsafe=True)
    return out.reshape(m, J)


def _segment_sum_ax(
    bucket: Bucket, x: torch.Tensor, J: int, plan: SegmentPlan
) -> torch.Tensor:
    """This bucket's contribution to A x: [m, J]."""
    return binned_segment_sum(bucket.idx, bucket.coeff * (x * bucket.mask)[None], J, plan)


def start_vector(n: int, seed: int, device) -> torch.Tensor:
    """Standard-normal start vector of the power iteration, drawn on the CPU
    from `torch.Generator().manual_seed(seed)` so it does not depend on the
    device (the JAX package draws its own from `jax.random.key(seed)`)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=gen, dtype=torch.float32).to(device)


@dataclasses.dataclass
class MatchingObjective:
    """ObjectiveFunction over a BucketedInstance (on the CPU or one card).

    `include_rhs=False` is the sharded-local mode of the reference: b is
    applied once globally after the cross-shard reduction, so grad/g here
    are pre-reduction contributions.
    """

    instance: BucketedInstance
    projection: ProjectionMap = dataclasses.field(
        default_factory=UnitSimplexProjection
    )
    include_rhs: bool = True
    # fused primal step: one kernel launch per bucket computes x
    fused_kernel: bool = False
    # one-pass fused dual oracle: one kernel launch per bucket per call
    # (subsumes fused_kernel)
    fused_oracle: bool = False
    # per-bucket summation order of A x, built at first use
    _plans: tuple[SegmentPlan, ...] | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    @property
    def dual_dim(self) -> int:
        return self.instance.dual_dim

    @property
    def _buckets(self) -> tuple[Bucket, ...]:
        """fp32 compute views of the buckets for the unfused paths."""
        return tuple(dequantize_bucket(b) for b in self.instance.buckets)

    def _simplex(self, kind: str) -> UnitSimplexProjection:
        if not isinstance(self.projection, UnitSimplexProjection):
            raise ValueError(f"the fused {kind} implements the simplex feasible set")
        return self.projection

    def primal_candidate(self, lam: torch.Tensor, gamma: float) -> tuple[torch.Tensor, ...]:
        """x*_gamma(lam) per bucket (eq. 3)."""
        inst = self.instance
        if self.fused_kernel:
            from repro_torch.kernels import ops as kops

            proj = self._simplex("primal kernel")
            return tuple(
                kops.fused_dual_primal(
                    b.idx, b.coeff, b.cost, b.mask, lam, gamma,
                    num_destinations=inst.num_destinations,
                    radius=proj.radius,
                    inequality=proj.inequality,
                    coeff_scale=b.coeff_scale,
                    cost_scale=b.cost_scale,
                )
                for b in inst.buckets
            )
        lam2 = lam.reshape(inst.num_families, inst.num_destinations)
        ginv = inv_gamma(gamma)
        return tuple(
            self.projection(-(gather_at_lam(b.coeff, b.idx, lam2) + b.cost) * ginv, b.mask)
            for b in self._buckets
        )

    def segment_plans(self) -> tuple[SegmentPlan, ...]:
        """Each bucket's `SegmentPlan`, sorted once per objective."""
        if self._plans is None:
            inst = self.instance
            self._plans = tuple(
                segment_plan(b.idx, inst.num_families, inst.num_destinations)
                for b in inst.buckets
            )
        return self._plans

    def apply_A(self, x_slabs: Sequence[torch.Tensor]) -> torch.Tensor:
        """A x as a [m*J] vector (accumulated in fp32, in a fixed order)."""
        inst = self.instance
        ax = torch.zeros(
            (inst.num_families, inst.num_destinations),
            dtype=torch.promote_types(x_slabs[0].dtype, torch.float32),
            device=inst.device,
        )
        for b, x, plan in zip(self._buckets, x_slabs, self.segment_plans()):
            ax = ax + _segment_sum_ax(b, x, inst.num_destinations, plan)
        return ax.reshape(-1)

    def apply_AT(self, lam: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """A^T lam per bucket (for power iteration / diagnostics)."""
        inst = self.instance
        lam2 = lam.reshape(inst.num_families, inst.num_destinations)
        return tuple(gather_at_lam(b.coeff, b.idx, lam2) * b.mask for b in self._buckets)

    def calculate(self, lam: torch.Tensor, gamma: float) -> DualEval:
        """(g, grad g, x*) — the paper's ObjectiveFunction.calculate (Table 1)."""
        if self.fused_oracle:
            return self._calculate_fused(lam, gamma)
        x_slabs = self.primal_candidate(lam, gamma)
        ax = self.apply_A(x_slabs)
        buckets = self._buckets
        lin = sum(_vdot(b.cost, _acc32(x)) for b, x in zip(buckets, x_slabs))
        ridge = 0.5 * gamma * sum(_vdot(_acc32(x), _acc32(x)) for x in x_slabs)
        return self._finish_eval(lam, ax, lin, ridge, x_slabs)

    def _finish_eval(self, lam, ax, lin, ridge, x_slabs) -> DualEval:
        """Shared tail of both oracle paths: grad/g from the reduced pieces."""
        grad = ax - self.instance.rhs if self.include_rhs else ax
        g = lin + ridge + _vdot(lam, grad)
        return DualEval(
            g=g, grad=grad, x_slabs=x_slabs, primal_linear=lin,
            primal_ridge=ridge, ax=ax,
        )

    def _calculate_fused(self, lam: torch.Tensor, gamma: float) -> DualEval:
        """One-pass oracle: per bucket ONE fused launch emits the primal slab
        plus this bucket's A x histogram and objective scalars."""
        from repro_torch.kernels import ops as kops

        proj = self._simplex("dual oracle")
        inst = self.instance
        ax2 = torch.zeros(
            (inst.num_families, inst.num_destinations), dtype=torch.float32,
            device=inst.device,
        )
        lin = sq = 0.0
        x_slabs = []
        for b in inst.buckets:
            x, hist, b_lin, b_sq = kops.fused_dual_oracle(
                b.idx, b.coeff, b.cost, b.mask, lam, gamma,
                num_destinations=inst.num_destinations,
                radius=proj.radius,
                inequality=proj.inequality,
                coeff_scale=b.coeff_scale,
                cost_scale=b.cost_scale,
            )
            x_slabs.append(x)
            ax2 = ax2 + hist
            lin = lin + b_lin
            sq = sq + b_sq
        return self._finish_eval(
            lam, ax2.reshape(-1), lin, 0.5 * gamma * sq, tuple(x_slabs)
        )

    # -- diagnostics --------------------------------------------------------

    def max_violation(self, x_slabs: Sequence[torch.Tensor]) -> torch.Tensor:
        """max(0, Ax - b) infinity-norm — the paper's Table-4 'slack'."""
        return torch.clamp_min(self.apply_A(x_slabs) - self.instance.rhs, 0.0).max()

    def power_iteration(
        self, seed: int, iters: int = 30, reduce: Callable | None = None
    ) -> torch.Tensor:
        """sigma_max(A)^2 estimate via power iteration on A A^T.

        Drives the analytic AGD step size 1/L, L = sigma_max^2 / gamma
        (paper §3.1).  The start vector comes from `start_vector(seed)`.
        `reduce` sums each step's A A^T u over the processes of a sharded
        solve (`core.sharding`).
        """
        u = start_vector(self.dual_dim, seed, self.instance.device)
        norm = None
        for _ in range(iters):
            u = self.apply_A(self.apply_AT(u / torch.linalg.vector_norm(u)))
            if reduce is not None:
                u = reduce(u)
            norm = torch.linalg.vector_norm(u)
        return norm  # ~ sigma_max^2


def normalize_rows(
    inst: BucketedInstance, eps: float = 1e-30
) -> tuple[BucketedInstance, np.ndarray]:
    """Jacobi preconditioning / row normalization (paper §6, Appendix B.2).

    Returns (scaled instance with A' = D A, b' = D b) and the diagonal D as a
    [m*J] vector, D_r = 1/||A_r||_2 (rows with zero norm keep D_r = 1).  The
    feasible set is unchanged; duals map back as lam_original = D lam'.
    Host-side numpy transform, as the reference runs it, once at instance
    build time; the scaled slabs return to the instance's device.
    """
    m, J = inst.num_families, inst.num_destinations
    dev = inst.device
    norms = np.sqrt(inst.row_norms_sq())
    d = np.where(norms > eps, 1.0 / np.maximum(norms, eps), 1.0)
    d2 = d.reshape(m, J)
    buckets = []
    for b in inst.buckets:
        idx = _host(b.idx)
        scale = d2[:, idx]  # [m, n, L]
        if b.coeff_scale is not None:
            # int8: dequantize, scale in fp32, requantize with fresh scales
            coeff_f32 = _host(b.coeff).astype(np.float32) * _host(b.coeff_scale)
            q, new_scale = _quantize_sym(
                (coeff_f32 * scale).astype(np.float32), axes=(1, 2)
            )
            buckets.append(dataclasses.replace(
                b, coeff=torch.from_numpy(q).to(dev),
                coeff_scale=torch.from_numpy(new_scale.astype(np.float32)).to(dev),
            ))
            continue
        coeff = torch.from_numpy(_host(b.coeff) * scale).to(b.coeff.dtype)
        buckets.append(dataclasses.replace(b, coeff=coeff.to(dev)))
    rhs = torch.from_numpy(_host(inst.rhs) * d).to(inst.rhs.dtype)
    scaled = dataclasses.replace(inst, buckets=tuple(buckets), rhs=rhs.to(dev))
    return scaled, d
