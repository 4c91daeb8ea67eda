"""ObjectiveFunction — the dual oracle (port of `repro.core.objective`).

`MatchingObjective.calculate(lam, gamma)` returns (g(lam), grad g(lam), x*(lam))
for the ridge-regularized matching LP:

    x*_gamma(lam) = Pi_C( -(A^T lam + c) / gamma )          (eq. 3)
    grad g(lam)   = A x*_gamma(lam) - b                      (eq. 4)
    g(lam)        = c'x* + (gamma/2)||x*||^2 + lam'(A x* - b)

over the bucketed-ELL layout: A^T lam is a per-bucket gather, A x a
per-bucket sum into J bins per family, in a fixed order (`binned_segment_sum`).  `fused_oracle=True` routes
the whole of `calculate` through the one-pass fused dual oracle
(`kernels.ops.fused_dual_oracle_call`): on the card one kernel launch for
every bucket of width <= 32 emits the primal slabs, A x and (c'x, ||x||^2)
from a single slab read, and a finalize launch sums them.
`fused_kernel=True` routes only the primal step through the fused primal
kernel (`kernels.ops.fused_dual_primal_call`, one launch); A x and the
objective terms stay on the plain path.  The projection
`UnitSimplexProjection(use_kernel=True)` projects every bucket's candidate
in one simplex-kernel call (`kernels.ops.fused_project_simplex_call`, one
launch).  The kernels' plans are built once per objective (`kernel_plan`).

A compiled formulation (`repro_torch.formulation`) rides on the instance
as its `formulation` field; `__post_init__` resolves it into per-bucket
projections and the lowered term scales (`cost_scale`, `ridge_weight`), so
the Maximizer, the sharded solve and the engines dispatch any composition
of feasible sets, terms and couplings unchanged.  A spec-free instance with
default scales is the matching formulation, bit for bit.  The fused paths
take unit scales and the simplex set only (`_assert_fused_ok`).

`gamma` is a Python float throughout,
so no call here waits for the device, apart from the first A x of an
objective, which sorts each bucket's bins once (`segment_plans`), and the
first fused-oracle call on the card, which fixes its fixed-point scale.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.projections import ProjectionMap, UnitSimplexProjection
from repro_torch.instances.buckets import (
    Bucket,
    BucketedInstance,
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
    "lane_segment_plan",
    "normalize_rows",
    "normalize_rows_traced",
    "row_norms_sq",
    "row_scales",
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
    return lane_segment_plan(idx[None], m, J)


def lane_segment_plan(idx: torch.Tensor, m: int, J: int) -> SegmentPlan:
    """`segment_plan` over the lanes of a stacked slab (idx [B, n, L], the
    tenant axis): the slot (b, k, s) goes to bin `(b*m + k)*J + idx[b, s]`,
    sorted stably, so every bin holds its slots in the solo plan's order."""
    B = idx.shape[0]
    offs = torch.arange(B * m, device=idx.device, dtype=torch.int64).view(B, m, 1) * J
    seg = (idx.reshape(B, 1, -1).long() + offs).reshape(-1)
    counts = torch.bincount(seg, minlength=B * m * J)
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
    # fused primal step: one kernel launch per call computes x
    fused_kernel: bool = False
    # one-pass fused dual oracle: one kernel launch (and a finalize) per call
    # (subsumes fused_kernel)
    fused_oracle: bool = False
    # lowered objective-term scales (repro_torch.formulation.terms):
    #   g = cost_scale * c'x + ridge_weight * (gamma/2)||x||^2 + lam'(Ax - b)
    #   x* = Pi_C( -(A^T lam + cost_scale * c) / (ridge_weight * gamma) )
    # the scale branches below are host-level, so unit scales compute the
    # matching objective's exact arithmetic
    cost_scale: float = 1.0
    ridge_weight: float = 1.0
    # per-bucket summation order of A x, built at first use
    _plans: tuple[SegmentPlan, ...] | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    # the fused kernels' plans on the card, built at first use
    _kernel_plans: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def __post_init__(self):
        # Formulation shim: a compiled FormulationSpec on the instance carries
        # the per-bucket feasible sets and term scales; resolve them here, so
        # every caller that builds a MatchingObjective from the instance
        # dispatches compiled formulations with no change.
        self._projections: Optional[tuple[ProjectionMap, ...]] = None
        spec = self.instance.formulation
        if spec is not None:
            from repro_torch.formulation.spec import lower_spec

            lowered = lower_spec(spec, self.instance)
            self.cost_scale = self.cost_scale * lowered.cost_scale
            self.ridge_weight = self.ridge_weight * lowered.ridge_weight
            # an explicitly passed non-default projection (the sharded solve's
            # `projection=` argument) wins over the spec's lowering
            if self.projection == UnitSimplexProjection():
                self._projections = lowered.projections
                if len(set(lowered.projections)) == 1:
                    self.projection = lowered.projections[0]
        # whether the fused kernels can take this objective, decided once:
        # (the one simplex projection of every bucket, None) or (None, why)
        self._fused = self._fused_simplex()

    @property
    def dual_dim(self) -> int:
        return self.instance.dual_dim

    @property
    def _buckets(self) -> tuple[Bucket, ...]:
        """fp32 compute views of the buckets for the unfused paths (fp32
        storage returns the instance's own buckets)."""
        return tuple(dequantize_bucket(b) for b in self.instance.buckets)

    def _proj(self, i: int) -> ProjectionMap:
        return self._projections[i] if self._projections else self.projection

    def _scaled_cost(self, b: Bucket) -> torch.Tensor:
        return b.cost if self.cost_scale == 1.0 else self.cost_scale * b.cost

    def _scaled_gamma(self, gamma: float) -> float:
        """ridge_weight * gamma, rounded to fp32 as the reference's product
        of a Python scale and an fp32 gamma."""
        if self.ridge_weight == 1.0:
            return gamma
        return float(np.float32(self.ridge_weight) * np.float32(gamma))

    def _fused_simplex(self) -> tuple[Optional[UnitSimplexProjection], Optional[str]]:
        if self.cost_scale != 1.0 or self.ridge_weight != 1.0:
            return None, ("implements unit term scales; lower non-unit "
                          "LinearCost/RidgeSmoothing through the unfused oracle")
        projs = {self._proj(i) for i in range(len(self.instance.buckets))}
        proj = next(iter(projs))
        if len(projs) != 1 or not isinstance(proj, UnitSimplexProjection):
            return None, "implements the simplex feasible set"
        return proj, None

    def _assert_fused_ok(self, kind: str) -> UnitSimplexProjection:
        """The one simplex projection of every bucket, which the fused
        kernels implement (decided at construction); raises on non-unit term
        scales or any other feasible set (the reference asserts the same)."""
        proj, why = self._fused
        if proj is None:
            raise ValueError(f"the {kind} {why}")
        return proj

    def primal_candidate(self, lam: torch.Tensor, gamma: float) -> tuple[torch.Tensor, ...]:
        """x*_gamma(lam) per bucket (eq. 3)."""
        inst = self.instance
        if self.fused_kernel:
            from repro_torch.kernels import ops as kops

            proj = self._assert_fused_ok("fused primal kernel")
            return kops.fused_dual_primal_call(
                inst.buckets, lam, gamma, num_destinations=inst.num_destinations,
                radius=proj.radius, inequality=proj.inequality,
                plan=self.kernel_plan("dual_primal"),
            )
        lam2 = lam.reshape(inst.num_families, inst.num_destinations)
        ginv = inv_gamma(self._scaled_gamma(gamma))
        buckets = self._buckets
        vs = [-(gather_at_lam(b.coeff, b.idx, lam2) + self._scaled_cost(b)) * ginv
              for b in buckets]
        projs = [self._proj(i) for i in range(len(buckets))]
        proj = projs[0]
        if (isinstance(proj, UnitSimplexProjection) and proj.use_kernel
                and len(set(projs)) == 1):
            from repro_torch.kernels import ops as kops

            return kops.fused_project_simplex_call(
                vs, [b.mask for b in buckets], radius=proj.radius,
                inequality=proj.inequality, plan=self.kernel_plan("simplex_proj"),
            )
        return tuple(p(v, b.mask) for p, v, b in zip(projs, vs, buckets))

    def kernel_plan(self, kernel: str):
        """The plan of the kernel `kernel` ("dual_oracle", "dual_primal" or
        "simplex_proj") over this objective's slabs, built once on the card
        (`kernels.ops.plan_slab_kernel`); None on the CPU."""
        if kernel not in self._kernel_plans:
            from repro_torch.kernels import ops as kops

            proj = self._assert_fused_ok({"dual_oracle": "fused dual oracle",
                                          "dual_primal": "fused primal kernel",
                                          "simplex_proj": "simplex kernel"}[kernel])
            inst = self.instance
            self._kernel_plans[kernel] = kops.plan_slab_kernel(
                kernel, inst.buckets, inst.num_destinations, radius=proj.radius,
                inequality=proj.inequality,
            )
        return self._kernel_plans[kernel]

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
        lin, ridge = self._primal_terms(x_slabs, gamma)
        return self._finish_eval(lam, ax, lin, ridge, x_slabs)

    def _primal_terms(self, x_slabs, gamma: float):
        """(c'x, (gamma/2)||x||^2), each with its term scale."""
        lin = sum(_vdot(self._scaled_cost(b), _acc32(x))
                  for b, x in zip(self._buckets, x_slabs))
        ridge = 0.5 * self._scaled_gamma(gamma) * sum(
            _vdot(_acc32(x), _acc32(x)) for x in x_slabs)
        return lin, ridge

    def _finish_eval(self, lam, ax, lin, ridge, x_slabs) -> DualEval:
        """Shared tail of both oracle paths: grad/g from the reduced pieces."""
        grad = ax - self.instance.rhs if self.include_rhs else ax
        g = lin + ridge + _vdot(lam, grad)
        return DualEval(
            g=g, grad=grad, x_slabs=x_slabs, primal_linear=lin,
            primal_ridge=ridge, ax=ax,
        )

    def _calculate_fused(self, lam: torch.Tensor, gamma: float) -> DualEval:
        """One-pass oracle: ONE fused call emits the primal slabs, A x and
        the objective scalars."""
        from repro_torch.kernels import ops as kops

        proj = self._assert_fused_ok("fused dual oracle")
        inst = self.instance
        x_slabs, ax, lin, sq = kops.fused_dual_oracle_call(
            inst.buckets, lam, gamma, num_destinations=inst.num_destinations,
            radius=proj.radius, inequality=proj.inequality,
            plan=self.kernel_plan("dual_oracle"),
        )
        return self._finish_eval(lam, ax, lin, 0.5 * gamma * sq, x_slabs)

    # -- diagnostics --------------------------------------------------------

    def primal_objective(self, x_slabs: Sequence[torch.Tensor], gamma: float) -> torch.Tensor:
        """c'x + (gamma/2)||x||^2 at `x_slabs`, with the term scales."""
        lin, ridge = self._primal_terms(x_slabs, gamma)
        return lin + ridge

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


def row_norms_sq(inst: BucketedInstance, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """||A_r||_2^2 per coupling row r = k*J + j, [m*J] in `dtype`, on the
    instance's device.

    Each slot's square is taken in fp32 (of the fp32 compute view) and
    summed in `dtype` by one `binned_segment_sum` over every bucket's slots
    in turn: a fixed order with no float atomics, and on the CPU bitwise
    the reference's sequential host sum (buckets, then families, then slots).
    """
    m, J = inst.num_families, inst.num_destinations
    compute = [dequantize_bucket(b) for b in inst.buckets]
    idx = torch.cat([b.idx.reshape(-1) for b in compute])
    sq = torch.cat([((b.coeff ** 2) * b.mask[None]).reshape(m, -1) for b in compute], dim=1)
    return binned_segment_sum(idx, sq.to(dtype), J).reshape(-1)


def row_scales(inst: BucketedInstance, eps: float = 1e-30) -> torch.Tensor:
    """The Jacobi diagonal in fp32 on the instance's device, as the engines
    apply it inside a solve: D_r = 1/||A_r||_2 (1 where the norm is zero),
    [m*J]."""
    norms = torch.sqrt(row_norms_sq(inst, torch.float32))
    return torch.where(norms > eps, 1.0 / torch.clamp_min(norms, eps), 1.0)


def _scaled(inst: BucketedInstance, d: torch.Tensor, requantize: bool) -> BucketedInstance:
    """A' = D A, b' = D b, the products taken in D's dtype and rounded to the
    stored dtypes.  int8 coefficients are requantized with fresh scales, or
    (`requantize=False`) kept as their dequantized fp32 products."""
    d2 = d.reshape(inst.num_families, inst.num_destinations)

    def scaled_bucket(b: Bucket) -> Bucket:
        cb = dequantize_bucket(b)
        coeff = cb.coeff.to(d.dtype) * d2[:, b.idx.long()]
        if b.coeff_scale is None:
            return dataclasses.replace(b, coeff=coeff.to(b.coeff.dtype))
        if requantize:
            q, scale = _quantize_sym(coeff.float(), dims=(1, 2))
            return dataclasses.replace(b, coeff=q, coeff_scale=scale)
        return dataclasses.replace(b, coeff=coeff.float(), cost=cb.cost, mask=cb.mask,
                                   coeff_scale=None, cost_scale=None)

    rhs = (inst.rhs.to(d.dtype) * d).to(inst.rhs.dtype)
    return dataclasses.replace(inst, buckets=tuple(scaled_bucket(b) for b in inst.buckets),
                               rhs=rhs)


def normalize_rows_traced(
    inst: BucketedInstance, eps: float = 1e-30
) -> tuple[BucketedInstance, torch.Tensor]:
    """Jacobi row normalization in fp32, as the engines run it inside every
    solve (port of the reference's traced form).

    `normalize_rows`' steps with the row norms, D and the products in fp32;
    bf16 coefficients are cast back, and int8 slabs stay dequantized fp32
    (requantizing would need data-dependent scales).  The formulation rides
    along.  Returns the scaled instance and D as a [m*J] fp32 tensor.
    """
    d = row_scales(inst, eps)
    return _scaled(inst, d, requantize=False), d


def normalize_rows(
    inst: BucketedInstance, eps: float = 1e-30
) -> tuple[BucketedInstance, torch.Tensor]:
    """Jacobi preconditioning / row normalization (paper §6, Appendix B.2).

    Returns (scaled instance with A' = D A, b' = D b) and the diagonal D as a
    [m*J] float64 tensor, D_r = 1/||A_r||_2 (rows with zero norm keep
    D_r = 1).  The feasible set is unchanged; duals map back as
    lam_original = D lam'.  Runs once at instance build time on the
    instance's device (span ``normalize``): the row norms summed in float64
    (`row_norms_sq`; only their m*J square roots on the host), each
    coefficient times its row's D in float64 and cast to the slab dtype
    (int8 requantized with fresh per-bucket scales), the rhs likewise to
    fp32.  On the CPU the result is the reference's host transform bit for
    bit.
    """
    with telemetry.span("normalize", device=inst.device):
        # the m*J norms' square roots in numpy: torch's CPU float64 sqrt is
        # not correctly rounded, and D has to be the host transform's
        norms = np.sqrt(row_norms_sq(inst, torch.float64).cpu().numpy())
        d = np.where(norms > eps, 1.0 / np.maximum(norms, eps), 1.0)
        d = torch.from_numpy(d).to(inst.device)
        return _scaled(inst, d, requantize=True), d
