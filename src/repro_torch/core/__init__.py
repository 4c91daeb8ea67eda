"""Solver core: projections, the dual oracle, the AGD maximizer, and its
column-sharded counterpart."""
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
]
