"""Hardware description template (LLMCompass paper, Sec. III-A, Fig. 3, Table I).

A *system* is devices + device-device interconnect.
A *device* is cores + global buffer + main memory.
A *core* is lanes + a shared local buffer.
A *lane* is an independent vector unit + systolic array + registers.

The template is deliberately agnostic between cache and scratchpad (the mapper
manages memory explicitly) and between HBM/DDR/CXL main memory (all are
bandwidth+capacity). TPUs are described with the same template following the
paper's own Table I convention for TPUv3.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from .units import (Bytes, BytesPerCycle, BytesPerSecond, FlopsPerCycle,
                    FlopsPerSecond, Hertz, Ratio, Seconds)

KB: Bytes = 1024
MB: Bytes = 1024 * KB
GB: Bytes = 1024 * MB


@dataclass(frozen=True)
class SystolicArray:
    rows: int
    cols: int
    # native PE datapath — prices die area (area.MAC_AREA) per dtype; the
    # timing model's narrow-datatype rate comes from the PrecisionPolicy
    # (precision.mac_scale), which is defined relative to this fp16 baseline
    dtype: str = "fp16"

    @property
    def macs(self) -> int:
        return self.rows * self.cols


@dataclass(frozen=True)
class VectorUnit:
    width: int                      # MACs (or ALU ops) per cycle per lane
    # fraction of peak usable for reductions / special functions (exp, rsqrt)
    special_ratio: Ratio = 1.0 / 4.0


@dataclass(frozen=True)
class Lane:
    vector_unit: VectorUnit
    systolic_array: SystolicArray
    register_file_bytes: Bytes = 256 * KB


@dataclass(frozen=True)
class Core:
    lanes: int
    lane: Lane
    local_buffer_bytes: Bytes       # shared among lanes (L1 / LDS / VMEM)
    # sustained local-buffer bandwidth in bytes/cycle (paper models buffers as
    # wide SRAM; per-core figure)
    local_buffer_bw_per_cycle: BytesPerCycle = 128


@dataclass(frozen=True)
class MainMemory:
    bandwidth_bytes: BytesPerSecond
    capacity_bytes: Bytes
    protocol: str = "HBM2e"


@dataclass(frozen=True)
class Device:
    name: str
    frequency_hz: Hertz
    core_count: int
    core: Core
    global_buffer_bytes: Bytes
    global_buffer_bw_per_cycle: BytesPerCycle  # bytes / clk (paper Table I)
    main_memory: Optional[MainMemory]
    # measured per-kernel launch + framework overhead (paper Sec. III-C:
    # "measured by running the operator with an input of size 1")
    kernel_launch_overhead_s: Seconds = 4.5e-6
    process_node_nm: int = 7

    # --- derived peak numbers -------------------------------------------------
    @property
    def total_lanes(self) -> int:
        return self.core_count * self.core.lanes

    @property
    def matmul_flops_per_cycle(self) -> FlopsPerCycle:
        """2 flops per MAC, all systolic arrays."""
        return 2 * self.total_lanes * self.core.lane.systolic_array.macs

    @property
    def vector_flops_per_cycle(self) -> FlopsPerCycle:
        return 2 * self.total_lanes * self.core.lane.vector_unit.width

    @property
    def peak_matmul_flops(self) -> FlopsPerSecond:
        return self.matmul_flops_per_cycle * self.frequency_hz

    @property
    def peak_vector_flops(self) -> FlopsPerSecond:
        return self.vector_flops_per_cycle * self.frequency_hz

    @property
    def memory_bandwidth(self) -> BytesPerSecond:
        """Bandwidth to the level that backs the global buffer.

        For GPU-style devices this is main-memory (HBM/DDR) bandwidth. For the
        paper's TPUv3 description the HBM *is* the global buffer, so its port
        bandwidth (bytes/clk x freq) is the figure.
        """
        if self.main_memory is not None:
            return self.main_memory.bandwidth_bytes
        return self.global_buffer_bw_per_cycle * self.frequency_hz

    @property
    def memory_capacity(self) -> Bytes:
        if self.main_memory is not None:
            return self.main_memory.capacity_bytes
        return float(self.global_buffer_bytes)

    @property
    def global_buffer_bandwidth(self) -> BytesPerSecond:
        return self.global_buffer_bw_per_cycle * self.frequency_hz


@dataclass(frozen=True)
class Link:
    """LogGP-style link (paper Sec. III-B2, Eq. 1-2)."""
    bandwidth_bytes: BytesPerSecond  # B
    latency_s: Seconds = 8.0e-6     # L
    overhead_s: Seconds = 1.0e-6    # O
    flit_bytes: Bytes = 16          # NVLink flit
    max_payload_bytes: Bytes = 256  # NVLink max payload


@dataclass(frozen=True)
class System:
    device: Device
    device_count: int
    link: Link
    topology: str = "ring"          # ring | fc (fully-connected) | torus2d

    def scaled(self, **kw) -> "System":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets (paper Table I, Table III, Table IV)
# ---------------------------------------------------------------------------

def make_core(lanes: int, vec_width: int, sa_rows: int,
              sa_cols: Optional[int] = None, local_kb: int = 192,
              register_file_kb: int = 256,
              local_buffer_bw_per_cycle: int = 128) -> Core:
    """Public constructor for custom core configurations (design what-ifs).

    Builds a Core of `lanes` lanes, each with a `vec_width`-wide vector unit
    and an `sa_rows` x `sa_cols` systolic array (square when sa_cols is
    omitted), sharing `local_kb` KiB of local buffer. Use with
    `dataclasses.replace(device, core=make_core(...))` to sweep compute
    organizations the way Sec. V does.
    """
    return Core(
        lanes=lanes,
        lane=Lane(VectorUnit(vec_width),
                  SystolicArray(sa_rows, sa_cols if sa_cols else sa_rows),
                  register_file_bytes=register_file_kb * KB),
        local_buffer_bytes=local_kb * KB,
        local_buffer_bw_per_cycle=local_buffer_bw_per_cycle,
    )


def _gpu_core(lanes: int, vec_width: int, sa: int, local_kb: int) -> Core:
    return make_core(lanes, vec_width, sa, local_kb=local_kb)


def with_mac_dtype(device: Device, dtype: str) -> Device:
    """Variant of `device` whose systolic PEs are built natively for `dtype`
    (same array geometry; smaller multipliers -> smaller die, area.MAC_AREA).
    Pair with the matching PrecisionPolicy when evaluating performance — the
    timing model does not stop you from running fp16 math on an int8 array.
    """
    lane = device.core.lane
    sa = replace(lane.systolic_array, dtype=dtype)
    return replace(
        device,
        name=f"{device.name}-{dtype}mac",
        core=replace(device.core, lane=replace(lane, systolic_array=sa)))


def nvidia_a100() -> Device:
    """NVIDIA A100 SXM4 80GB (Table I). 108 binned SMs."""
    return Device(
        name="nvidia-a100",
        frequency_hz=1410e6,
        core_count=108,
        core=_gpu_core(lanes=4, vec_width=32, sa=16, local_kb=192),
        global_buffer_bytes=40 * MB,
        global_buffer_bw_per_cycle=5120,
        main_memory=MainMemory(2.0e12, 80 * GB, "HBM2e"),
    )


def nvidia_ga100() -> Device:
    """Full GA100 die: 128 SMs (Table IV baseline)."""
    return replace(nvidia_a100(), name="nvidia-ga100", core_count=128,
                   global_buffer_bytes=48 * MB)


def amd_mi210() -> Device:
    return Device(
        name="amd-mi210",
        frequency_hz=1700e6,
        core_count=104,
        core=_gpu_core(lanes=4, vec_width=16, sa=16, local_kb=80),
        global_buffer_bytes=8 * MB,
        global_buffer_bw_per_cycle=4096,
        main_memory=MainMemory(1.6e12, 64 * GB, "HBM2e"),
    )


def nvidia_h100() -> Device:
    """NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU architecture
    whitepaper): 132 SMs of 4 tensor-core lanes, 989.4 TFLOP/s dense bf16,
    67 TFLOP/s fp32, 80 GB HBM3 at 3.35 TB/s, 50 MB L2, 228 KB of shared
    memory per SM.

    The bf16 peak fixes the clock: 2048 dense bf16 MACs per SM and cycle
    (4 lanes of a 16x32 array) give 2 * 132 * 2048 * f = 989.4e12 at
    f = 1.83 GHz, the boost clock the whitepaper's tensor-core peaks assume.
    The fp32 peak (128 FP32 cores per SM at 1.98 GHz) is 34.7 fp32 FMAs per
    lane at that one clock; 35 gives 67.6 TFLOP/s. The L2's bytes per cycle
    are not published: the A100 preset's 5120 is kept."""
    return Device(
        name="nvidia-h100",
        frequency_hz=1.83e9,
        core_count=132,
        core=make_core(lanes=4, vec_width=35, sa_rows=16, sa_cols=32,
                       local_kb=228),
        global_buffer_bytes=50 * MB,
        global_buffer_bw_per_cycle=5120,
        main_memory=MainMemory(3.35e12, 80 * GB, "HBM3"),
        process_node_nm=4,
    )


def google_tpu_v3() -> Device:
    """One TPUv3 chip, 2 cores (Table I convention: HBM backs global buffer)."""
    return Device(
        name="google-tpu-v3",
        frequency_hz=940e6,
        core_count=2,
        core=Core(
            lanes=1,
            lane=Lane(VectorUnit(4 * 128), SystolicArray(128, 128)),
            local_buffer_bytes=8192 * KB,
        ),
        global_buffer_bytes=16384 * MB,
        global_buffer_bw_per_cycle=490,
        main_memory=None,
        kernel_launch_overhead_s=20e-6,   # XLA dispatch, paper Sec. III-C
    )


def google_tpu_v5e() -> Device:
    """TPU v5e — our deployment target (197 TFLOP/s bf16, 819 GB/s HBM).

    One core per chip; 128x128 MXUs + 8x128 VPU; VMEM is the local buffer.
    197e12 / (2 MACs) / freq(940MHz v5e ~ 1.67GHz) -> 4 MXUs of 128x128 at
    ~1.74 GHz gives 2*4*16384*1.74e9 = 228 TF; clocking at 1.5GHz gives 196.6.
    """
    return Device(
        name="google-tpu-v5e",
        frequency_hz=1.5e9,
        core_count=1,
        core=Core(
            lanes=4,  # 4 MXUs
            lane=Lane(VectorUnit(8 * 128), SystolicArray(128, 128)),
            local_buffer_bytes=128 * MB,
        ),
        global_buffer_bytes=128 * MB,
        global_buffer_bw_per_cycle=546,   # 819 GB/s / 1.5 GHz
        main_memory=MainMemory(819e9, 16 * GB, "HBM2e"),
        kernel_launch_overhead_s=10e-6,
    )


# --- Table III compute-system designs A-E ----------------------------------

def compute_design(which: str) -> Device:
    spec = {
        #        cores lanes vec   sa   local_kb
        "A": (128, 4, 8, 8, 192),
        "B": (128, 4, 32, 16, 192),
        "C": (128, 1, 128, 32, 192),
        "D": (32, 1, 512, 64, 768),
        "E": (8, 1, 2048, 128, 3072),
    }[which]
    cores, lanes, vec, sa, local_kb = spec
    return replace(
        nvidia_ga100(),
        name=f"design-{which}",
        core_count=cores,
        core=_gpu_core(lanes=lanes, vec_width=vec, sa=sa, local_kb=local_kb),
    )


# --- Table IV proposed designs ----------------------------------------------

def latency_oriented() -> Device:
    """Half the compute + SRAM of GA100, same HBM memory system."""
    return replace(
        nvidia_ga100(),
        name="latency-oriented",
        core_count=64,
        global_buffer_bytes=24 * MB,
        global_buffer_bw_per_cycle=2560,
    )


def throughput_oriented() -> Device:
    """4x systolic/local-buffer per core, half the cores, 512GB DDR @ 1TB/s."""
    return replace(
        nvidia_ga100(),
        name="throughput-oriented",
        core_count=64,
        core=_gpu_core(lanes=4, vec_width=32, sa=32, local_kb=768),
        global_buffer_bytes=48 * MB,
        main_memory=MainMemory(1.0e12, 512 * GB, "PCIe 5.0/CXL DDR5"),
    )


# --- Systems -----------------------------------------------------------------

def dgx_a100(n: int = 4) -> System:
    return System(device=nvidia_a100(), device_count=n,
                  link=Link(bandwidth_bytes=600e9), topology="fc")


def tpu_v3_node(n_chips: int = 4) -> System:
    return System(device=google_tpu_v3(), device_count=n_chips,
                  link=Link(bandwidth_bytes=162.5e9, flit_bytes=16,
                            max_payload_bytes=256),
                  topology="torus2d")


def tpu_v5e_pod(n: int = 256) -> System:
    """16x16 v5e pod slice; ~50 GB/s per ICI link per direction."""
    return System(device=google_tpu_v5e(), device_count=n,
                  link=Link(bandwidth_bytes=50e9, latency_s=1e-6,
                            flit_bytes=16, max_payload_bytes=256),
                  topology="torus2d")


def make_system(device: Device, n: int, link_gbps: float = 600.0,
                topology: str = "fc") -> System:
    return System(device=device, device_count=n,
                  link=Link(bandwidth_bytes=link_gbps * 1e9), topology=topology)


PRESETS = {
    "a100": nvidia_a100,
    "ga100": nvidia_ga100,
    "h100": nvidia_h100,
    "mi210": amd_mi210,
    "tpuv3": google_tpu_v3,
    "tpuv5e": google_tpu_v5e,
    "latency-oriented": latency_oriented,
    "throughput-oriented": throughput_oriented,
    **{f"design-{w}": (lambda w=w: compute_design(w)) for w in "ABCDE"},
}


def get_device(name: str) -> Device:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown device preset '{name}'; have {sorted(PRESETS)}")
