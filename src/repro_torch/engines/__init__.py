"""Solver engines (port of `repro.engines`): the layer between the dual
oracle and the service.

See `base` for the contract, `agd` and `pdhg` for the two engines, and
`selector` for the per-tenant adaptive routing policy.
"""
from repro_torch.engines.base import ENGINES, Engine, RawSolve, resolve_engine
from repro_torch.engines.selector import EngineSelector

__all__ = [
    "ENGINES",
    "Engine",
    "EngineSelector",
    "RawSolve",
    "resolve_engine",
]
