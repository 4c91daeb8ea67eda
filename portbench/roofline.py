"""The yardstick's peaks and work counts: what one NVIDIA H100 SXM can do, and
the least work a matching solve needs, from the instance's shapes alone.

Peaks are NVIDIA's data-sheet numbers for the SXM part at its 700 W limit
(dense, no sparsity).  The counts do not depend on how the program computes:
each input byte is read once, each output byte written once, whatever a
kernel reads again.
"""
from __future__ import annotations

__all__ = [
    "HBM_BYTES_PER_S",
    "FP32_FLOPS",
    "ITEMSIZE",
    "bound_s",
    "oracle_call_bytes",
    "oracle_call_flops",
    "power_step_bytes",
    "power_step_flops",
    "solve_bound_s",
]

HBM_BYTES_PER_S = 3.35e12  # HBM3, 80 GB
FP32_FLOPS = 67e12  # fp32 outside the tensor cores

ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def _slots(shapes: dict) -> int:
    return sum(length * rows for length, rows in shapes["buckets"])


def oracle_call_bytes(shapes: dict) -> int:
    """One dual-oracle call at duals lam: per slab slot the destination id
    (int32), m coefficients, the cost and the mask read at the slab's width
    and x written (fp32 for int8 slabs); lam read and A x written, fp32."""
    m, s = shapes["families"], ITEMSIZE[shapes["slab_dtype"]]
    x = 4 if shapes["slab_dtype"] == "int8" else s
    dual = 4 * m * shapes["destinations"]
    return _slots(shapes) * (4 + (m + 2) * s + x) + 2 * dual


def oracle_call_flops(shapes: dict) -> int:
    """Per slot: A^T lam (2m), the cost and the 1/gamma scale (2), the
    projection's threshold and clamp (4), A x (2m), c'x and ||x||^2 (4)."""
    return _slots(shapes) * (4 * shapes["families"] + 10)


def power_step_bytes(shapes: dict) -> int:
    """One power-iteration step u -> A A^T u: A^T reads ids and
    coefficients, A reads them again (its input is an intermediate per slot,
    written once and read once at fp32)."""
    m, s = shapes["families"], ITEMSIZE[shapes["slab_dtype"]]
    dual = 4 * m * shapes["destinations"]
    return _slots(shapes) * (2 * (4 + m * s) + 2 * 4) + 2 * dual


def power_step_flops(shapes: dict) -> int:
    return _slots(shapes) * 4 * shapes["families"]


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of work that moves `nbytes` and does `flops`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def solve_bound_s(shapes: dict, oracle_calls: int, power_steps: int) -> float:
    """The least time of a solve: its oracle calls and power steps."""
    return (oracle_calls * bound_s(oracle_call_bytes(shapes), oracle_call_flops(shapes))
            + power_steps * bound_s(power_step_bytes(shapes), power_step_flops(shapes)))
