"""Cost model (paper Sec. III-D, Table IV).

Per-die cost from supply-chain wafer modeling [Ning et al., ISCA'23]:
dies-per-wafer geometry + defect-limited yield, with a salvage factor for
designs that bin/disable faulty units (A100 ships 108/128 SMs). Memory cost
from spot pricing: the paper's own Table IV implies ~$7/GB HBM2e and
~$0.30/GB DDR5 — we use exactly those.

No IP/mask/packaging costs, matching the paper's scope.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .hardware import Device, GB
from .units import Dollars, Mm2, Ratio

WAFER_COST_7NM_USD: Dollars = 9346.0  # TSMC N7, public supply-chain estimate
WAFER_DIAMETER_MM = 300.0
DEFECT_DENSITY_PER_MM2 = 0.001       # ~0.1 defects/cm^2 (mature N7)
SALVAGE_YIELD: Ratio = 0.90          # binning recovers most defective dies
HBM_USD_PER_GB: Dollars = 7.0        # per GB of HBM2e
DDR_USD_PER_GB: Dollars = 0.30       # per GB of DDR5


def dies_per_wafer(die_area_mm2: Mm2) -> int:
    """Standard DPW geometry: area term minus edge-loss term."""
    d = WAFER_DIAMETER_MM
    return int(math.pi * (d / 2) ** 2 / die_area_mm2
               - math.pi * d / math.sqrt(2.0 * die_area_mm2))


def die_yield(die_area_mm2: Mm2, salvage: bool = True) -> Ratio:
    """Poisson defect yield; salvage floors it for redundancy-binned designs."""
    y = math.exp(-DEFECT_DENSITY_PER_MM2 * die_area_mm2)
    if salvage:
        y = max(y, SALVAGE_YIELD)
    return y


def die_cost(die_area_mm2: Mm2, salvage: bool = True) -> Dollars:
    dpw = dies_per_wafer(die_area_mm2)
    return WAFER_COST_7NM_USD / (dpw * die_yield(die_area_mm2, salvage))


def memory_cost(device: Device) -> Dollars:
    if device.main_memory is None:
        return 0.0
    gb = device.main_memory.capacity_bytes / GB
    if "HBM" in device.main_memory.protocol.upper():
        return gb * HBM_USD_PER_GB
    return gb * DDR_USD_PER_GB


@dataclass
class CostReport:
    die_area_mm2: Mm2
    die_cost_usd: Dollars
    memory_cost_usd: Dollars

    @property
    def total_usd(self) -> Dollars:
        return self.die_cost_usd + self.memory_cost_usd


def device_cost(device: Device, die_area_mm2: Mm2) -> CostReport:
    return CostReport(die_area_mm2=die_area_mm2,
                      die_cost_usd=die_cost(die_area_mm2),
                      memory_cost_usd=memory_cost(device))
