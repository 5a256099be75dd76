"""Platform constants of the analytic model (copy of
``repro.core.hardware``, cut to the paper's platforms).

These are the paper's Section VI-A platform constants: a wafer-scale chip
(WSC) of B200-equivalent dies, DGX B200 and NVL72. They are modelled, not
measured, and describe none of the port's hardware: no number here is a
speed of the port or of the card it runs on.

All bandwidths are bytes/second, latencies in seconds, compute in FLOP/s.
"""

from __future__ import annotations

import dataclasses

TB = 1e12
GB = 1e9
US = 1e-6


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Per-device compute/memory capability."""

    name: str
    flops: float           # peak FLOP/s at the evaluation precision
    hbm_bytes: float       # memory capacity
    hbm_bw: float          # memory bandwidth, bytes/s
    # Sustained efficiency knobs used by the analytical compute model.
    flops_efficiency: float = 0.7
    hbm_efficiency: float = 0.8

    def compute_time(self, flops: float, bytes_moved: float) -> float:
        """Roofline execution-time estimate for one kernel invocation."""
        return max(
            flops / (self.flops * self.flops_efficiency),
            bytes_moved / (self.hbm_bw * self.hbm_efficiency),
        )


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One network link class: per-direction bandwidth and per-hop latency."""

    bw: float              # bytes/s, per direction
    latency: float         # seconds per hop (link + protocol)


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """A deployable platform = device spec + network link classes.

    ``intra`` is the dense local network (on-wafer d2d / NVLink), ``inter``
    the cross-group network (cross-wafer border / InfiniBand). For
    single-tier platforms ``inter`` simply equals ``intra``.
    """

    name: str
    device: DeviceSpec
    intra: LinkSpec
    inter: LinkSpec
    group_size: int        # devices inside one high-bw island (node/wafer)


# Each WSC die is assumed B200-equivalent: 2250 TFLOPS FP16, 180 GB HBM at
# 8 TB/s. Die-to-die bidirectional bandwidth 8 TB/s (=> 4 TB/s per
# direction), one-border cross-wafer 9 TB/s (=> 4.5 TB/s per direction).
B200_DIE = DeviceSpec(
    name="B200",
    flops=2250e12,
    hbm_bytes=180 * GB,
    hbm_bw=8 * TB,
)

WSC = PlatformSpec(
    name="WSC",
    device=B200_DIE,
    intra=LinkSpec(bw=4 * TB, latency=0.05 * US),
    inter=LinkSpec(bw=4.5 * TB, latency=0.2 * US),
    group_size=64,  # one 8x8 wafer
)

# DGX B200: 8 GPUs per node on NVLink5 (1.8 TB/s bidir => 0.9 TB/s per
# direction), nodes joined by 400 GB/s InfiniBand with ~2 us latency.
DGX = PlatformSpec(
    name="DGX",
    device=B200_DIE,
    intra=LinkSpec(bw=0.9 * TB, latency=0.3 * US),
    inter=LinkSpec(bw=0.05 * TB, latency=2.0 * US),
    group_size=8,
)

# NVL72: 72 dies behind a unified NVLink switch fabric.
NVL72 = PlatformSpec(
    name="NVL72",
    device=B200_DIE,
    intra=LinkSpec(bw=0.9 * TB, latency=0.3 * US),
    inter=LinkSpec(bw=0.9 * TB, latency=0.3 * US),
    group_size=72,
)

PLATFORMS = {p.name: p for p in (WSC, DGX, NVL72)}
