"""Full Token Domain (FTD) analysis (copy of ``repro.core.ftd``; paper
Section IV-A).

The FTD of a device is the minimal set of devices that together hold
tokens from all TP groups. Its geometry predicts the MoE all-to-all cost:
the mean pairwise hop distance between members, and the overlap of FTD
bounding boxes, which forces routed traffic of different FTDs through
shared links.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.er_mapping import Mapping


@dataclasses.dataclass(frozen=True)
class FTDStats:
    avg_hops: float              # mean pairwise hop distance within FTDs
    max_hops: int                # diameter of the widest FTD
    avg_bbox_area: float         # mean bounding-box area
    n_intersecting_pairs: int    # FTD pairs with overlapping bounding boxes
    intersection_area: float     # total pairwise bbox overlap area


def _bbox(coords: list[tuple[int, int]]) -> tuple[int, int, int, int]:
    rs = [r for r, _ in coords]
    cs = [c for _, c in coords]
    return min(rs), min(cs), max(rs), max(cs)


def _bbox_overlap(a, b) -> int:
    r0 = max(a[0], b[0])
    c0 = max(a[1], b[1])
    r1 = min(a[2], b[2])
    c1 = min(a[3], b[3])
    if r1 < r0 or c1 < c0:
        return 0
    return (r1 - r0 + 1) * (c1 - c0 + 1)


def ftd_stats(mapping: Mapping) -> FTDStats:
    topo = mapping.topo
    hop_sum, hop_n, hop_max = 0.0, 0, 0
    areas = []
    boxes = []
    for devs in mapping.ftds:
        coords = [topo.coord(d) for d in devs]
        for a, b in itertools.combinations(coords, 2):
            h = topo.hops(a, b)
            hop_sum += h
            hop_n += 1
            hop_max = max(hop_max, h)
        box = _bbox(coords)
        boxes.append(box)
        areas.append((box[2] - box[0] + 1) * (box[3] - box[1] + 1))

    n_inter, inter_area = 0, 0.0
    for a, b in itertools.combinations(boxes, 2):
        ov = _bbox_overlap(a, b)
        if ov:
            n_inter += 1
            inter_area += ov
    return FTDStats(
        avg_hops=hop_sum / max(hop_n, 1),
        max_hops=hop_max,
        avg_bbox_area=float(np.mean(areas)),
        n_intersecting_pairs=n_inter,
        intersection_area=inter_area,
    )
