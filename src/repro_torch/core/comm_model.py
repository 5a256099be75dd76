"""Analytical communication cost model (copy of ``repro.core.comm_model``;
paper Eq. 1 and Section IV).

Every cost is built from the paper's latency law

    latency = (volume / bandwidth + link_latency) x hops          (Eq. 1)

applied per link class (intra-wafer vs cross-wafer), plus per-link traffic
accounting on the mesh: a traffic matrix is routed XY-deterministically and
accumulated per directed link, so congestion (the paper's FTD-intersection
effect) emerges from the placement instead of being an assumed constant.

Mesh collectives: ``mesh_allreduce`` (ring reduce-scatter + all-gather over
each TP group's ring; entwined rings are time-staggered, so intersecting
ring edges do not contend), ``hier_allreduce`` (HER: intra-wafer
reduce-scatter + inter-wafer all-gather) and ``mesh_alltoall`` (MoE
dispatch + combine, confined to FTDs with the all-gather retained, or
spread to the reduce-scatter owners without it). Switched clusters (DGX,
NVL72): ``cluster_allreduce`` and ``cluster_alltoall``, two-tier models
over NVLink islands joined by InfiniBand (or one NVLink domain).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.er_mapping import Mapping
from repro_torch.core.hardware import LinkSpec, PlatformSpec
from repro_torch.core.topology import MeshTopology


@dataclasses.dataclass(frozen=True)
class CommResult:
    time: float                 # total estimated seconds
    transfer: float             # bandwidth component
    latency: float              # link-latency component
    max_link_bytes: float = 0.0
    link_loads: np.ndarray | None = None

    def __add__(self, other: "CommResult") -> "CommResult":
        loads = None
        if self.link_loads is not None and other.link_loads is not None:
            loads = self.link_loads + other.link_loads
        elif self.link_loads is not None:
            loads = self.link_loads
        elif other.link_loads is not None:
            loads = other.link_loads
        return CommResult(
            self.time + other.time,
            self.transfer + other.transfer,
            self.latency + other.latency,
            max(self.max_link_bytes, other.max_link_bytes),
            loads,
        )


ZERO = CommResult(0.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# link-class helpers
# ---------------------------------------------------------------------------

def _link_specs(topo: MeshTopology, platform: PlatformSpec) -> tuple[np.ndarray, np.ndarray]:
    """Per-link (bw, latency) arrays, honouring cross-wafer link class."""
    bw = np.empty(topo.n_links)
    lat = np.empty(topo.n_links)
    for i, l in enumerate(topo.links):
        spec: LinkSpec = platform.inter if topo.is_cross_wafer(l) else platform.intra
        bw[i] = spec.bw
        lat[i] = spec.latency
    return bw, lat


def route_traffic(
    topo: MeshTopology,
    traffic: dict[tuple[int, int], float],
    platform: PlatformSpec,
) -> tuple[np.ndarray, float, float]:
    """Route a traffic matrix.

    Returns (per-link byte loads, max route latency, traffic-weighted mean
    hop count). The mean hop count is the Eq. 1 store-and-forward
    amplification: a message on an h-hop path pays its bandwidth term h
    times (the paper's ``x hops`` factor)."""
    _, lat = _link_specs(topo, platform)
    loads = np.zeros(topo.n_links)
    idx = topo.link_index
    max_lat = 0.0
    vol_sum = 0.0
    vol_hops = 0.0
    for (s, d), vol in traffic.items():
        if s == d or vol <= 0.0:
            continue
        route = topo.route(topo.coord(s), topo.coord(d))
        route_lat = 0.0
        for link in route:
            li = idx[link]
            loads[li] += vol
            route_lat += lat[li]
        max_lat = max(max_lat, route_lat)
        vol_sum += vol
        vol_hops += vol * len(route)
    mean_hops = vol_hops / vol_sum if vol_sum else 0.0
    return loads, max_lat, mean_hops


def _congested_time(
    topo: MeshTopology,
    platform: PlatformSpec,
    loads: np.ndarray,
    max_route_lat: float,
    mean_hops: float,
) -> CommResult:
    bw, _ = _link_specs(topo, platform)
    per_link = loads / bw
    # Bottleneck link x store-and-forward amplification (Eq. 1's hop factor
    # on the bandwidth term; congestion already lives in the max).
    transfer = float(per_link.max(initial=0.0)) * max(mean_hops, 1.0)
    return CommResult(
        time=transfer + max_route_lat,
        transfer=transfer,
        latency=max_route_lat,
        max_link_bytes=float(loads.max(initial=0.0)),
        link_loads=loads,
    )


def _route_time(
    topo: MeshTopology, platform: PlatformSpec, src: int, dst: int, vol: float
) -> float:
    """Eq. 1 for a single transfer with per-link classes:
    sum over links of (vol/bw_l + lat_l)."""
    t = 0.0
    for link in topo.route(topo.coord(src), topo.coord(dst)):
        spec = platform.inter if topo.is_cross_wafer(link) else platform.intra
        t += vol / spec.bw + spec.latency
    return t


def _ring_edges(groups: list[list[int]]):
    """Every cyclic (a, b) edge of every ring, in ring order."""
    for devs in groups:
        for i in range(len(devs)):
            yield devs[i], devs[(i + 1) % len(devs)]


# ---------------------------------------------------------------------------
# mesh all-reduce (ring / entwined ring)
# ---------------------------------------------------------------------------

def mesh_allreduce(
    mapping: Mapping,
    platform: PlatformSpec,
    bytes_per_device: float,
    retain_ag: bool = True,
    groups: list[list[int]] | None = None,
) -> CommResult:
    """Ring all-reduce over every TP group's ring, concurrently.

    Per phase (reduce-scatter, all-gather) there are ``n - 1`` steps; each
    step moves one ``bytes/n`` chunk along every ring edge. Entwined rings
    (ER) have multi-hop edges; intersecting edges of different rings are
    time-staggered (paper Section IV-B2), so the step time is the slowest
    single edge transfer, not a contended one.

    ``groups`` overrides the reduction domains (default: the TP groups);
    the ESP combine passes the FTDs here, compact 1-hop tiles under ER.
    """
    topo = mapping.topo
    groups = groups if groups is not None else mapping.tp_groups
    n = len(groups[0])
    if n == 1:
        return ZERO
    chunk = bytes_per_device / n
    phases = 2 if retain_ag else 1
    steps = phases * (n - 1)

    # Slowest ring edge across all groups (Eq. 1, mixed link classes).
    step_time = 0.0
    for a, b in _ring_edges(groups):
        step_time = max(step_time, _route_time(topo, platform, a, b, chunk))

    # Heatmap: every ring edge carries ``steps`` chunks over the run.
    traffic: dict[tuple[int, int], float] = {}
    for a, b in _ring_edges(groups):
        traffic[(a, b)] = traffic.get((a, b), 0.0) + chunk * steps
    loads, _, _ = route_traffic(topo, traffic, platform)

    total = steps * step_time
    # Split transfer/latency components for reporting.
    lat_part = 0.0
    for a, b in _ring_edges(groups):
        h = topo.hops(topo.coord(a), topo.coord(b))
        lat_part = max(lat_part, h * platform.intra.latency)
    lat_total = steps * lat_part
    return CommResult(
        time=total,
        transfer=total - lat_total,
        latency=lat_total,
        max_link_bytes=float(loads.max(initial=0.0)),
        link_loads=loads,
    )


def hier_allreduce(
    mapping: Mapping,
    platform: PlatformSpec,
    bytes_per_device: float,
) -> CommResult:
    """HER-Mapping all-reduce: intra-wafer reduce-scatter, then inter-wafer
    exchange of the scattered shards over the border links (Fig. 10(c)).

    After phase 1 each device holds a distinct reduced shard, so phase 2
    moves only ``bytes/tp_local`` per device across wafers, instead of
    dragging full ring chunks over the border ``tp - 1`` times.
    """
    topo = mapping.topo
    if topo.n_wafers == 1:
        return mesh_allreduce(mapping, platform, bytes_per_device)
    n_w = topo.n_wafers
    m = mapping.tp // n_w                      # wafer-local ring size
    if m < 1:
        raise ValueError("tp smaller than wafer count")

    # Phase 1: intra-wafer ring reduce-scatter over each wafer-local segment.
    chunk = bytes_per_device / m
    step_time = 0.0
    traffic: dict[tuple[int, int], float] = {}
    for g in range(mapping.dp):
        devs = mapping.tp_groups[g]
        for w in range(n_w):
            seg = devs[w * m : (w + 1) * m]
            for i in range(len(seg) - 1):
                a, b = seg[i], seg[i + 1]
                step_time = max(step_time, _route_time(topo, platform, a, b, chunk))
                traffic[(a, b)] = traffic.get((a, b), 0.0) + chunk * (m - 1)
    phase1 = (m - 1) * step_time

    # Phase 2: inter-wafer all-gather(+reduce) of corresponding shards:
    # ring over the ``n_w`` wafer-replicas of each shard, 2(n_w - 1) steps.
    shard = bytes_per_device / m
    step2 = 0.0
    for g in range(mapping.dp):
        devs = mapping.tp_groups[g]
        for i in range(m):
            for w in range(n_w - 1):
                a = devs[w * m + (i if w % 2 == 0 else m - 1 - i)]
                b = devs[(w + 1) * m + (i if (w + 1) % 2 == 0 else m - 1 - i)]
                step2 = max(step2, _route_time(topo, platform, a, b, shard))
                traffic[(a, b)] = traffic.get((a, b), 0.0) + shard * 2 * (n_w - 1)
    phase2 = 2 * (n_w - 1) * step2

    loads, max_lat, _ = route_traffic(topo, traffic, platform)
    total = phase1 + phase2
    return CommResult(
        time=total,
        transfer=total - max_lat,
        latency=max_lat,
        max_link_bytes=float(loads.max(initial=0.0)),
        link_loads=loads,
    )


# ---------------------------------------------------------------------------
# mesh all-to-all (MoE dispatch + combine)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class A2AWorkload:
    tokens_per_group: int       # tokens held by one TP group (full set, post AG)
    token_bytes: int            # hidden * bytes_per_element
    topk: int                   # experts activated per token
    device_load: np.ndarray | None = None  # per-device receive weight, mean ~1


def _a2a_traffic(
    mapping: Mapping, wl: A2AWorkload, retain_ag: bool
) -> dict[tuple[int, int], float]:
    topo = mapping.topo
    n = topo.n_devices
    total_dispatch = mapping.dp * wl.tokens_per_group * wl.topk  # token copies
    base_recv = total_dispatch / n
    load = wl.device_load if wl.device_load is not None else np.ones(n)

    traffic: dict[tuple[int, int], float] = {}

    def add(s: int, d: int, vol: float) -> None:
        if s != d and vol > 0:
            traffic[(s, d)] = traffic.get((s, d), 0.0) + vol

    if retain_ag:
        # Each destination fetches tokens of group g from the member of g in
        # its own FTD (nearest source, guaranteed by AG).
        for devs in mapping.ftds:
            for dst in devs:
                recv = base_recv * load[dst] * wl.token_bytes
                per_group = recv / mapping.dp
                for src in devs:
                    if mapping.group_of[src] != mapping.group_of[dst]:
                        add(src, dst, per_group)
    else:
        # Without AG, token shards live on their reduce-scatter owners:
        # fetch uniformly from every member of every group.
        for dst in range(n):
            recv = base_recv * load[dst] * wl.token_bytes
            per_member = recv / (mapping.dp * mapping.tp)
            for g in range(mapping.dp):
                for src in mapping.tp_groups[g]:
                    add(src, dst, per_member)
    return traffic


def mesh_alltoall(
    mapping: Mapping,
    platform: PlatformSpec,
    wl: A2AWorkload,
    retain_ag: bool = True,
) -> CommResult:
    """Dispatch + combine all-to-all on the mesh (two symmetric phases)."""
    topo = mapping.topo
    dispatch = _a2a_traffic(mapping, wl, retain_ag)
    combine = {(d, s): v for (s, d), v in dispatch.items()}
    r1 = _congested_time(topo, platform, *route_traffic(topo, dispatch, platform))
    r2 = _congested_time(topo, platform, *route_traffic(topo, combine, platform))
    return r1 + r2


# ---------------------------------------------------------------------------
# switched-cluster references (DGX / NVL72)
# ---------------------------------------------------------------------------

def cluster_allreduce(
    platform: PlatformSpec, n_devices: int, bytes_per_device: float
) -> CommResult:
    """Two-tier ring all-reduce on NVLink islands joined by an IB fabric.

    ``n_devices`` is the reduction domain (a TP group): callers pass the
    TP size, which deployments keep inside one NVLink island."""
    s = min(platform.group_size, n_devices)
    k = max(n_devices // s, 1)
    intra_t = 2 * (s - 1) / s * bytes_per_device / platform.intra.bw
    intra_l = 2 * (s - 1) * platform.intra.latency
    inter_t = 2 * (k - 1) / k * bytes_per_device / platform.inter.bw
    inter_l = 2 * (k - 1) * platform.inter.latency
    return CommResult(
        time=intra_t + intra_l + inter_t + inter_l,
        transfer=intra_t + inter_t,
        latency=intra_l + inter_l,
    )


def cluster_alltoall(
    platform: PlatformSpec,
    n_devices: int,
    per_device_bytes: float,
    imbalance: float = 1.0,
    hier_factor: float = 2.0,
) -> CommResult:
    """Dispatch+combine all-to-all: every device exchanges
    ``per_device_bytes`` spread uniformly over all peers; cross-island
    traffic rides the (slow) inter fabric. ``hier_factor`` models the
    hierarchical intra-node aggregation of DeepSpeed-MoE-style systems
    (the paper's baseline): duplicate token copies to the same remote node
    are merged before crossing IB."""
    s = min(platform.group_size, n_devices)
    frac_inter = (n_devices - s) / n_devices / max(hier_factor, 1.0)
    frac_intra = (s - 1) / n_devices
    one_phase_t = imbalance * per_device_bytes * max(
        frac_inter / platform.inter.bw, frac_intra / platform.intra.bw
    )
    lat = platform.inter.latency if n_devices > s else platform.intra.latency
    return CommResult(
        time=2 * (one_phase_t + lat),
        transfer=2 * one_phase_t,
        latency=2 * lat,
    )


# ---------------------------------------------------------------------------
# hot / cold link analysis (Section V-A)
# ---------------------------------------------------------------------------

def cold_links(loads: np.ndarray, frac: float = 0.05) -> np.ndarray:
    """Boolean mask of links whose load is below ``frac`` of the max."""
    peak = loads.max(initial=0.0)
    if peak == 0.0:
        return np.ones_like(loads, dtype=bool)
    return loads <= frac * peak


def link_heatmaps(
    mapping: Mapping,
    platform: PlatformSpec,
    bytes_per_device: float,
    wl: A2AWorkload,
) -> tuple[np.ndarray, np.ndarray]:
    """(all-reduce loads, all-to-all loads) per link: Fig. 11(a)(b)."""
    return (
        mesh_allreduce(mapping, platform, bytes_per_device).link_loads,
        mesh_alltoall(mapping, platform, wl).link_loads,
    )
