"""Shared helpers for the paper-figure modules (copy of
``benchmarks/common.py``)."""

from __future__ import annotations

from repro_torch.core.er_mapping import MAPPINGS
from repro_torch.core.hardware import DGX, NVL72, WSC
from repro_torch.core.simulator import ClusterSystem, WSCSystem
from repro_torch.core.topology import MeshTopology


def wsc_system(rows, cols, dp, tp, mapping="er", n_wafers=1, hier=False):
    topo = MeshTopology(rows, cols, n_wafers)
    return WSCSystem(WSC, MAPPINGS[mapping](topo, dp, tp), hierarchical=hier)


def dgx_system(n_devices, tp=8):
    return ClusterSystem(DGX, n_devices, tp=tp)


def nvl72_system(tp=8):
    return ClusterSystem(NVL72, 72, tp=tp)


def row(name: str, us: float, derived: str) -> dict:
    return {"name": name, "us_per_call": round(us, 3), "derived": derived}


def comm_us(bd) -> float:
    """Communication latency of one iteration (us)."""
    return (bd.allreduce + bd.alltoall) * 1e6
