"""Analysis of the port's runs: the roofline terms on the NVIDIA H100, the
analytic LM FLOPs model (`flops_model`) and the collectives of a traced
step (`comm_stats`, the counterpart of the reference's `hlo_stats`, which
parses XLA HLO that PyTorch does not make).
"""
from repro_torch.analysis.comm_stats import TraceCounter, collective_stats
from repro_torch.analysis.flops_model import CellCost, cell_cost
from repro_torch.analysis.roofline import H100, H100_HBM_BYTES, HW, RooflineTerms, roofline_from_stats

__all__ = ["H100", "H100_HBM_BYTES", "HW", "RooflineTerms", "roofline_from_stats",
           "TraceCounter", "collective_stats", "CellCost", "cell_cost"]
