"""Per-tenant adaptive engine selection (port of `repro.engines.selector`;
the reference's `ServiceConfig.engine = "auto"`).

The scheduler observes, per tenant, how many iterations each engine needed
to hit tolerance, keeps a decayed (EWMA) score per (tenant, engine), and
routes the tenant to the cheaper engine at dispatch time.  Cheap by design:

  * **Exploration** is bounded and deterministic — each engine must be tried
    `explore_cadences` times before scores are trusted, and the exploration
    ORDER is rotated by a stable hash of the tenant name (crc32, not
    Python's salted `hash`), so a mixed workload exercises both engines from
    cadence 0 and a restored checkpoint replays identical routing.
  * **Non-convergence is penalized**, not ignored: a solve that exhausted
    its budget scores `iters * penalty`, so an engine that burns the whole
    budget without converging loses to one that converges in the same
    iterations.
  * **Scores decay** (`s <- decay * s + (1-decay) * obs`), so a tenant whose
    instance drifts toward the other engine's sweet spot migrates after a
    few cadences instead of being grandfathered forever.

State is two plain dicts (JSON-serializable); a `state_dict()` written by
this class or by the reference's loads in either (`load_state`).
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional

from repro_torch.engines.base import ENGINES

__all__ = ["EngineSelector"]


def _stable_rotation(tenant: str, n: int) -> int:
    return zlib.crc32(tenant.encode("utf-8")) % n


class EngineSelector:
    """Decaying iterations-to-tol tracker with deterministic routing."""

    def __init__(
        self,
        decay: float = 0.7,
        explore_cadences: int = 1,
        penalty: float = 2.0,
    ):
        if not (0.0 <= decay < 1.0):
            raise ValueError("decay must lie in [0, 1)")
        self.decay = float(decay)
        self.explore_cadences = int(explore_cadences)
        self.penalty = float(penalty)
        self._scores: Dict[str, Dict[str, float]] = {}
        self._counts: Dict[str, Dict[str, int]] = {}

    # ---- routing ----------------------------------------------------------
    def exploration_order(self, tenant: str) -> tuple[str, ...]:
        r = _stable_rotation(tenant, len(ENGINES))
        return ENGINES[r:] + ENGINES[:r]

    def choose(self, tenant: str) -> str:
        """Engine for this tenant's next solve (pure given observed state)."""
        counts = self._counts.get(tenant, {})
        order = self.exploration_order(tenant)
        for engine in order:
            if counts.get(engine, 0) < self.explore_cadences:
                return engine
        scores = self._scores[tenant]
        # ties break on the engine name so routing is reproducible
        return min(order, key=lambda e: (scores[e], e))

    # ---- observation ------------------------------------------------------
    def observe(
        self, tenant: str, engine: str, iters: int, converged: bool
    ) -> None:
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        obs = float(iters) * (1.0 if converged else self.penalty)
        scores = self._scores.setdefault(tenant, {})
        counts = self._counts.setdefault(tenant, {})
        if engine in scores:
            scores[engine] = self.decay * scores[engine] + (
                1.0 - self.decay
            ) * obs
        else:
            scores[engine] = obs
        counts[engine] = counts.get(engine, 0) + 1

    # ---- checkpointing ----------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "decay": self.decay,
            "explore_cadences": self.explore_cadences,
            "penalty": self.penalty,
            "scores": {t: dict(s) for t, s in self._scores.items()},
            "counts": {t: dict(c) for t, c in self._counts.items()},
        }

    def load_state(self, state: Optional[dict]) -> None:
        if not state:
            return
        self.decay = float(state.get("decay", self.decay))
        self.explore_cadences = int(
            state.get("explore_cadences", self.explore_cadences)
        )
        self.penalty = float(state.get("penalty", self.penalty))
        self._scores = {
            t: {e: float(v) for e, v in s.items()}
            for t, s in state.get("scores", {}).items()
        }
        self._counts = {
            t: {e: int(v) for e, v in c.items()}
            for t, c in state.get("counts", {}).items()
        }
