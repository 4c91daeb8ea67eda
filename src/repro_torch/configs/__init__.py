"""Workload configurations of the port (port of `repro.configs`).

Only the paper's own LP workload scales for now (`LP_INSTANCES`, the
reference's Table 2/3 scales as generator specs): the architectures, shapes
and input specs of `repro.configs` describe the LM substrate, which the port
has not reached yet.  Dry runs (`repro_torch.launch.dryrun`) size these on
the analytic bucket layout (`instances.specs`).
"""

__all__ = ["LP_INSTANCES"]

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
