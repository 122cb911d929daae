"""Area model (paper Sec. III-D, Table II).

Bottom-up: lane = vector FPUs + systolic MACs + register file + per-lane
overhead; core = lanes + local-buffer SRAM + per-core overhead; device =
cores + global-buffer SRAM + memory PHY/controller + interconnect PHY.

Constants: Table II gives the 7nm areas for the FPU, ALU, per-lane overhead,
per-core overhead and HBM2e control/PHY. SRAM (CACTI scaled to 7nm) and
register-file (EMPIRE) curves are fitted so the model reproduces the paper's
own die-area validation (GA100 826 mm^2 within ~10%, Fig. 6a) and its
Table IV design areas (478 / 826 / 787 mm^2) — the fit is documented here
rather than hidden in a fudge factor.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .hardware import Device, MB
from .precision import DTYPES
from .units import Mm2

UM2: Mm2 = 1e-6   # mm^2 per um^2

# --- Table II constants (7nm) ----------------------------------------------
AREA_FP64_FPU: Mm2 = 7116 * UM2
AREA_FP32_FPU: Mm2 = AREA_FP64_FPU / 2     # half-width datapath

# Systolic PE area, per native datapath dtype. The fp16 MAC is
# THE calibrated constant: together with the fabric constant below it makes
# the model reproduce the paper's own Table IV triple exactly-ish — GA100
# 826 / latency 478 / throughput 787 mm^2 form a linear system in
# (MAC area, fabric, IO); solving it gives 1150 um^2/MAC, 1.45 mm^2/core
# fabric, 130 mm^2 mem+IO. (This note is the single home of that fit;
# lane_area and the device breakdown both read the table through
# _lane_parts, so the constant is applied in exactly one place.)
# Narrow datapaths scale by the registry's per-dtype multiplier-area ratios
# (precision.DTYPES.mac_area_rel: ~quadratic in operand width, fixed-point
# cheaper than floating) — derived, so a new registry dtype prices here
# automatically.
MAC_UM2_FP16 = 1150
MAC_AREA = {name: d.mac_area_rel * MAC_UM2_FP16 * UM2
            for name, d in DTYPES.items()}
AREA_FP16_MAC = MAC_AREA["fp16"]           # back-compat alias
AREA_INT32_ALU: Mm2 = 1838 * UM2
AREA_LANE_OVERHEAD: Mm2 = 10344 * UM2
AREA_CORE_OVERHEAD: Mm2 = 460000 * UM2     # Table II per-core overhead
AREA_CORE_FABRIC: Mm2 = 1450000 * UM2      # calibrated crossbar/uncore share
AREA_HBM2E_CTRL_1024: Mm2 = 5740000 * UM2  # per 1024-bit channel (scales w/ node)
AREA_HBM2E_PHY_1024: Mm2 = 10450000 * UM2  # per 1024-bit channel (analog, fixed)

# --- fitted memory-macro curves (documented calibration) -------------------
SRAM_LOCAL_MM2_PER_MB: Mm2 = 2.0   # high-port L1/LDS SRAM @ 7nm (CACTI-fit)
SRAM_GLOBAL_MM2_PER_MB: Mm2 = 1.2  # dense L2-class SRAM @ 7nm
REGFILE_MM2_PER_MB: Mm2 = 4.0      # multi-ported RF (EMPIRE-fit)
HBM_GBPS_PER_STACK = 400.0     # HBM2e per-1024b-stack bandwidth (~3.2 Gbps/pin)
DDR_PHY_MM2_PER_CH: Mm2 = 0.18     # PCIe5/DDR channel PHY+ctrl (perimeter IO)
DDR_GBPS_PER_CH = 4.0          # ~PCIe 5.0 x1 effective
LINK_PHY_MM2_PER_GBPS: Mm2 = 49.0 / 600.0  # NVLink SerDes (Table IV fit)


@dataclass
class AreaReport:
    lane_mm2: Mm2
    core_mm2: Mm2
    cores_total_mm2: Mm2
    global_buffer_mm2: Mm2
    memory_io_mm2: Mm2
    link_phy_mm2: Mm2
    breakdown: dict = field(default_factory=dict)

    @property
    def total_mm2(self) -> Mm2:
        return (self.cores_total_mm2 + self.global_buffer_mm2
                + self.memory_io_mm2 + self.link_phy_mm2)


def _lane_parts(device: Device) -> dict:
    """Per-lane area components — the one place the unit constants are
    applied (lane_area and the device breakdown both sum these)."""
    lane = device.core.lane
    sa = lane.systolic_array
    try:
        mac = MAC_AREA[sa.dtype]
    except KeyError:
        raise KeyError(f"no MAC area entry for systolic dtype {sa.dtype!r}; "
                       f"have {sorted(MAC_AREA)}")
    return {
        "vector_units": lane.vector_unit.width * AREA_FP32_FPU,
        "systolic_arrays": sa.macs * mac,
        "register_files": (lane.register_file_bytes / MB)
        / device.core.lanes * REGFILE_MM2_PER_MB,
        "lane_overhead": AREA_LANE_OVERHEAD,
    }


def lane_area(device: Device) -> Mm2:
    return sum(_lane_parts(device).values())


def core_area(device: Device) -> Mm2:
    lanes = device.core.lanes * lane_area(device)
    local = (device.core.local_buffer_bytes / MB) * SRAM_LOCAL_MM2_PER_MB
    return lanes + local + AREA_CORE_OVERHEAD + AREA_CORE_FABRIC


def device_area(device: Device,
                link_bandwidth_gbps: float = 600.0) -> AreaReport:
    la: Mm2 = lane_area(device)
    ca: Mm2 = core_area(device)
    cores: Mm2 = device.core_count * ca
    gb: Mm2 = (device.global_buffer_bytes / MB) * SRAM_GLOBAL_MM2_PER_MB

    mem_io: Mm2 = 0.0
    if device.main_memory is not None:
        bw_gbps = device.main_memory.bandwidth_bytes / 1e9
        if "HBM" in device.main_memory.protocol.upper():
            stacks = max(1, round(bw_gbps / HBM_GBPS_PER_STACK))
            mem_io = stacks * (AREA_HBM2E_CTRL_1024 + AREA_HBM2E_PHY_1024)
        else:
            channels = max(1, round(bw_gbps / DDR_GBPS_PER_CH))
            mem_io = channels * DDR_PHY_MM2_PER_CH

    link = link_bandwidth_gbps * LINK_PHY_MM2_PER_GBPS

    rep = AreaReport(
        lane_mm2=la, core_mm2=ca, cores_total_mm2=cores,
        global_buffer_mm2=gb, memory_io_mm2=mem_io, link_phy_mm2=link)
    parts = _lane_parts(device)
    rep.breakdown = {
        **{k: device.total_lanes * v for k, v in parts.items()},
        "local_buffers": device.core_count
        * (device.core.local_buffer_bytes / MB) * SRAM_LOCAL_MM2_PER_MB,
        "core_overhead": device.core_count
        * (AREA_CORE_OVERHEAD + AREA_CORE_FABRIC),
        "global_buffer": gb,
        "memory_io": mem_io,
        "link_phy": link,
    }
    return rep
