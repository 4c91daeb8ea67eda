"""Three-term roofline model (port of `repro.analysis.roofline`, retargeted
from the TPU v5e to the NVIDIA H100).

    compute    = FLOPs_global            / (chips * peak_FLOP/s)
    memory     = bytes_global            / (chips * HBM_bw)
    collective = collective_bytes_global / (chips * link_bw)

The inputs are per device (global = per_device * chips).  The dominant term
is the bottleneck; roofline fraction = dominant / sum (how close the
dominant resource is to being the only cost, i.e. perfect overlap), and
MODEL_FLOPS / FLOPs catches redundant work.  The port's inputs are analytic
(`repro_torch.launch.dryrun`): PyTorch lowers nothing to inspect.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["H100", "H100_HBM_BYTES", "HW", "RooflineTerms", "roofline_from_stats"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float  # per chip, dense bf16
    hbm_bw: float  # bytes/s per chip
    link_bw: float  # bytes/s per chip and direction (NVLink)


# NVIDIA H100 SXM5 data sheet, at its full 700 W power limit: HBM3 at
# 3.35 TB/s, 989.4 TFLOP/s dense BF16 on the tensor cores, NVLink 900 GB/s
# per card (450 GB/s each way).  Named as `nvidia-smi --query-gpu=
# name,power.limit` prints the card the port runs on; a card set below
# 700 W runs slower under load.
H100 = HW(name="NVIDIA H100 80GB HBM3, 700.00 W", peak_flops=989.4e12, hbm_bw=3.35e12,
          link_bw=450e9)
H100_HBM_BYTES = 80e9  # device memory (data sheet: 80 GB)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: Optional[float] = None  # 6*N*D (or 6*N_active*D)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if self.model_flops is None or self.flops_per_device <= 0:
            return None
        return self.model_flops / (self.flops_per_device * self.chips)

    @property
    def mfu_bound(self) -> Optional[float]:
        """Model-FLOPs utilisation if the dominant term were the runtime."""
        if self.model_flops is None or self.bound_s <= 0:
            return None
        hw_flops = self.flops_per_device * self.chips / max(self.compute_s, 1e-30)
        return self.model_flops / (self.bound_s * hw_flops)

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def roofline_from_stats(
    flops_per_device: float,
    bytes_per_device: float,
    coll_bytes_per_device: float,
    chips: int,
    hw: HW = H100,
    model_flops: Optional[float] = None,
) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / hw.peak_flops,
        memory_s=bytes_per_device / hw.hbm_bw,
        collective_s=coll_bytes_per_device / hw.link_bw,
        chips=chips,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll_bytes_per_device,
        model_flops=model_flops,
    )
