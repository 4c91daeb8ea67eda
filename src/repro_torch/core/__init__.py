"""Solver core: projections, the dual oracle, and the AGD maximizer."""
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
    "start_vector",
    "ProjectionMap",
    "UnitSimplexProjection",
    "BoxProjection",
    "BoxCutProjection",
    "project_simplex",
    "project_box",
    "project_box_cut",
]
