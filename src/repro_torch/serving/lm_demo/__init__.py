"""LM-demo serving (token generation, not LP allocation; port of
`repro.serving.lm_demo`).

Kept apart from the dual-serving API that owns ``repro_torch.serving``: this
sub-package serves *tokens* from an LM architecture, while the parent
package serves *allocations* from device-resident duals.  `steps.py` holds
the sharded serve steps over a mesh (`make_serve_fns`, `lower_decode_step`,
`lower_prefill`).
"""
from repro_torch.serving.lm_demo.steps import (
    lower_decode_step,
    lower_prefill,
    make_serve_fns,
)
from repro_torch.serving.lm_demo.engine import Request, ServeEngine

__all__ = [
    "lower_decode_step",
    "lower_prefill",
    "make_serve_fns",
    "ServeEngine",
    "Request",
]
