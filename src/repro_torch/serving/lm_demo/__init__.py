"""LM-demo serving (token generation, not LP allocation; port of
`repro.serving.lm_demo`).

Kept apart from the dual-serving API that owns ``repro_torch.serving``: this
sub-package serves *tokens* from an LM architecture, while the parent
package serves *allocations* from device-resident duals.  The reference's
sharded serve steps (`steps.py`: `make_serve_fns`, `lower_decode_step`,
`lower_prefill`) need the sharding rules (`training/sharding_rules.py`)
and a mesh, and come with them.
"""
from repro_torch.serving.lm_demo.engine import Request, ServeEngine

__all__ = [
    "ServeEngine",
    "Request",
]
