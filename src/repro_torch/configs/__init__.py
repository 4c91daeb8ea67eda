"""Workload configurations of the port (port of `repro.configs`).

Two kinds of workload.  The LM substrate's ten assigned architectures: each
lives in its own module exposing CONFIG (the exact published configuration)
and REDUCED (a same-family small config for CPU tests), with the shapes of
the reference's cells and `input_specs`, which builds meta-device tensors
(PyTorch's counterpart of `jax.ShapeDtypeStruct`: shapes and dtypes, no
storage) for every model input of an (arch x shape) cell.  And the paper's
own LP workload scales (`LP_INSTANCES`, the reference's Table 2/3 scales as
generator specs), which the solver dry run (`repro_torch.launch.dryrun`)
sizes on the analytic bucket layout (`instances.specs`).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

__all__ = [
    "ShapeSpec",
    "SHAPES",
    "ARCH_IDS",
    "get_config",
    "get_reduced_config",
    "applicable_shapes",
    "skip_reason",
    "input_specs",
    "LP_INSTANCES",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

ARCH_IDS: tuple[str, ...] = (
    "internvl2-76b",
    "gemma-7b",
    "qwen3-8b",
    "qwen2-72b",
    "starcoder2-7b",
    "deepseek-v2-236b",
    "kimi-k2-1t-a32b",
    "seamless-m4t-medium",
    "zamba2-2.7b",
    "mamba2-1.3b",
)


def _module(arch: str):
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
    )


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """Why an (arch, shape) cell is skipped, or None if it runs.

    long_500k needs sub-quadratic sequence mixing: runs for SSM/hybrid,
    skipped for pure full-attention archs.
    """
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "full-attention arch: 500k decode needs sub-quadratic mixing"
    return None


def applicable_shapes(cfg: ModelConfig) -> list[ShapeSpec]:
    return [s for s in SHAPES.values() if skip_reason(cfg, s) is None]


def input_specs(cfg: ModelConfig, shape: ShapeSpec, model=None) -> dict:
    """Meta-device tensors for every input of this (arch, shape) cell."""
    from repro_torch.models.model import Model

    model = model or Model(cfg)
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.encdec:
            return {
                "embeds": sds((B, S, cfg.d_model), f32),  # frame stub
                "tokens": sds((B, S), i32),
                "labels": sds((B, S), i32),
            }
        if cfg.frontend == "patch":
            P = cfg.frontend_len
            return {
                "embeds": sds((B, P, cfg.d_model), f32),  # patch stub
                "tokens": sds((B, S - P), i32),
                "labels": sds((B, S), i32),
            }
        return {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.encdec:
            return {
                "embeds": sds((B, S, cfg.d_model), f32),
                "tokens": sds((B, 1), i32),
            }
        if cfg.frontend == "patch":
            P = cfg.frontend_len
            return {
                "embeds": sds((B, P, cfg.d_model), f32),
                "tokens": sds((B, S - P), i32),
            }
        return {"tokens": sds((B, S), i32)}
    # decode: one new token against a seq_len cache
    return {
        "tokens": sds((B, 1), i32),
        "pos": sds((), i32),
        "cache": model.init_cache(B, S, device="meta"),
    }


# The paper's own workload configurations (Table 2/3 scales), expressed as
# generator specs.  Dry runs use the analytic bucket layout; CPU benchmarks
# materialise the smaller ones.
LP_INSTANCES: dict[str, dict] = {
    # name: sources, destinations, avg_degree, families
    "s25M-d10K": dict(num_sources=25_000_000, num_destinations=10_000, avg_degree=10.0, num_families=1),
    "s50M-d10K": dict(num_sources=50_000_000, num_destinations=10_000, avg_degree=10.0, num_families=1),
    "s75M-d10K": dict(num_sources=75_000_000, num_destinations=10_000, avg_degree=10.0, num_families=1),
    "s100M-d10K": dict(num_sources=100_000_000, num_destinations=10_000, avg_degree=10.0, num_families=1),
}
