"""Communication-primitive models (paper Sec. III-B2).

Link model (AHEAD / LogGP):   T = L + O + n_hat / B
with framing                  n_hat = ceil(n / MaxPayload) * Flit + n

On top: ring all-reduce (bandwidth-optimal, the paper's choice), plus
all-gather / reduce-scatter / all-to-all / p2p — the paper models only
all-reduce and p2p because Megatron-style TP needs nothing else; we add the
rest because sequence-parallel TP (RS+AG) and MoE expert-parallel (A2A)
plans need them. All reuse the same link equation.

The PyTorch port's copy of the JAX package's link models, whole.
"""
from __future__ import annotations

import math
from typing import Optional

from .hardware import Link, System
from .operators import OpResult
from .units import Bytes, BytesPerElement, Elements, Flops, \
    FlopsPerElement, Ratio, Seconds

#: one reduction add per payload element in a ring reduce step
REDUCE_FLOPS_PER_ELEMENT: FlopsPerElement = 1.0


def link_time(link: Link, n_bytes: Bytes) -> Seconds:
    """Eq. 1-2: time to move n bytes across one link."""
    if n_bytes <= 0:
        return 0.0
    n_hat: Bytes = (math.ceil(n_bytes / link.max_payload_bytes)
                    * link.flit_bytes + n_bytes)
    return link.latency_s + link.overhead_s + n_hat / link.bandwidth_bytes


def p2p(system: System, n_bytes: Bytes, name: str = "p2p") -> OpResult:
    t: Seconds = link_time(system.link, n_bytes)
    return OpResult(name, t, 0.0, 0.0, "link")


def all_reduce(system: System, n_bytes: Bytes,
               n_devices: Optional[int] = None,
               name: str = "all_reduce",
               bytes_elt: BytesPerElement = 2.0) -> OpResult:
    """Ring all-reduce: 2(n-1) steps of n_bytes/n chunks (reduce-scatter then
    all-gather phase). Reduction adds vector work, usually negligible —
    priced at the collective's actual element width (`bytes_elt`): each of
    the (n-1) reduce-scatter steps adds chunk/bytes_elt elements, so an fp8
    payload does twice the adds per byte of an fp16 one."""
    n: Ratio = n_devices or system.device_count
    if n <= 1:
        return OpResult(name, 0.0, 0.0, 0.0, "link")
    chunk: Bytes = n_bytes / n
    t: Seconds = 2 * (n - 1) * link_time(system.link, chunk)
    red_elems: Elements = (n - 1) * chunk / bytes_elt
    red_flops: Flops = red_elems * REDUCE_FLOPS_PER_ELEMENT
    t += red_flops / system.device.peak_vector_flops
    return OpResult(name, t, red_flops, 2 * (n - 1) * chunk, "link")


def reduce_scatter(system: System, n_bytes: Bytes,
                   n_devices: Optional[int] = None,
                   name: str = "reduce_scatter",
                   bytes_elt: BytesPerElement = 2.0) -> OpResult:
    """Ring reduce-scatter: (n-1) steps, each reducing a chunk — the same
    per-element adds as all_reduce's first phase, priced at `bytes_elt` so
    SP (RS+AG) and AR plans compete on equal reduction accounting."""
    n: Ratio = n_devices or system.device_count
    if n <= 1:
        return OpResult(name, 0.0, 0.0, 0.0, "link")
    chunk: Bytes = n_bytes / n
    t: Seconds = (n - 1) * link_time(system.link, chunk)
    red_elems: Elements = (n - 1) * chunk / bytes_elt
    red_flops: Flops = red_elems * REDUCE_FLOPS_PER_ELEMENT
    t += red_flops / system.device.peak_vector_flops
    return OpResult(name, t, red_flops, (n - 1) * chunk, "link")


def all_gather(system: System, n_bytes: Bytes,
               n_devices: Optional[int] = None,
               name: str = "all_gather") -> OpResult:
    """n_bytes = full gathered size."""
    n: Ratio = n_devices or system.device_count
    if n <= 1:
        return OpResult(name, 0.0, 0.0, 0.0, "link")
    chunk: Bytes = n_bytes / n
    t: Seconds = (n - 1) * link_time(system.link, chunk)
    return OpResult(name, t, 0.0, (n - 1) * chunk, "link")


def all_to_all(system: System, n_bytes: Bytes,
               n_devices: Optional[int] = None,
               name: str = "all_to_all") -> OpResult:
    """Each device exchanges n_bytes/n with every peer. On a ring this is
    (n-1) steps with average hop distance n/4 worth of occupancy; on
    fully-connected, one step of the largest message per link."""
    n: Ratio = n_devices or system.device_count
    if n <= 1:
        return OpResult(name, 0.0, 0.0, 0.0, "link")
    per_pair: Bytes = n_bytes / n
    if system.topology == "fc":
        # dedicated pairwise links: serialize (n-1) sends on the NIC port
        t: Seconds = link_time(system.link, per_pair) \
            + (n - 2) * per_pair / system.link.bandwidth_bytes
    else:
        # ring/torus: bisection-limited; total relayed bytes per link ~ n/4 x
        t = link_time(system.link, per_pair * n / 4) * 2
    return OpResult(name, t, 0.0, per_pair * (n - 1), "link")
