"""Solver core: projections, the dual oracle, the AGD maximizer, and its
column-sharded counterpart; plus gamma-stability control (`stability`) and
the unstructured COO PDHG baseline the paper compares against (`pdhg`)."""
from repro_torch.core.maximizer import (
    PAPER_GAMMA_SCHEDULE,
    Maximizer,
    MaximizerConfig,
    SolveResult,
    StageStats,
    step_size,
)
from repro_torch.core.objective import (
    DualEval,
    MatchingObjective,
    binned_segment_sum,
    normalize_rows,
    normalize_rows_traced,
    start_vector,
)
from repro_torch.core.projections import (
    BoxCutProjection,
    BoxProjection,
    ProjectionMap,
    UnitSimplexProjection,
    project_box,
    project_box_cut,
    project_simplex,
    project_simplex_cmp,
)
from repro_torch.core.sharding import (
    DistConfig,
    DistributedMaximizer,
    shard_instance,
)
from repro_torch.core.stability import RecurringSolver, drift_bound, primal_drift
from repro_torch.core.pdhg import COOLP, PDHGConfig, from_edge_list, solve_pdhg

__all__ = [
    "PAPER_GAMMA_SCHEDULE",
    "Maximizer",
    "MaximizerConfig",
    "SolveResult",
    "StageStats",
    "step_size",
    "DualEval",
    "MatchingObjective",
    "binned_segment_sum",
    "normalize_rows",
    "normalize_rows_traced",
    "start_vector",
    "DistConfig",
    "DistributedMaximizer",
    "shard_instance",
    "ProjectionMap",
    "UnitSimplexProjection",
    "BoxProjection",
    "BoxCutProjection",
    "project_simplex",
    "project_simplex_cmp",
    "project_box",
    "project_box_cut",
    "drift_bound",
    "primal_drift",
    "RecurringSolver",
    "COOLP",
    "PDHGConfig",
    "solve_pdhg",
    "from_edge_list",
]
