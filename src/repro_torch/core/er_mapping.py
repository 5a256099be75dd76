"""Entwined Ring Mapping (copy of ``repro.core.er_mapping``; paper
Section IV).

A *mapping* assigns every device of a 2-D mesh a (TP-group, rank) pair for
the attention layers. Three placements:

* ``baseline_mapping``: each TP group occupies a contiguous block of the
  mesh (Fig. 8(b)); FTDs are the devices at equal block offsets, large
  bounding boxes that all overlap in the mesh centre.
* ``er_mapping``: TP groups are entwined; the mesh is cut into compact
  tiles of ``dp`` devices, each holding one member of every TP group
  (Fig. 8(c)). Each tile is an FTD; the TP all-reduce runs on entwined
  multi-hop rings over the tiles (Fig. 8(d)).
* ``hierarchical_er_mapping`` (HER, Fig. 10(c)): per-wafer ER with the
  groups striped across wafers, so the all-reduce of a multi-wafer system
  splits into intra-wafer reduce-scatter and inter-wafer all-gather.

The ``Mapping`` records placement and ring order; costs live in
``comm_model``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import Coord, MeshTopology


def grid_cycle(h: int, w: int) -> list[Coord]:
    """A Hamiltonian cycle over an ``h x w`` grid with unit steps (a snake
    path for odd x odd grids)."""
    if h == 1 or w == 1:
        return [(r, c) for r in range(h) for c in range(w)]
    if h % 2 == 0:
        cyc: list[Coord] = [(0, c) for c in range(w)]
        for r in range(1, h):
            cols = range(w - 1, 0, -1) if r % 2 == 1 else range(1, w)
            cyc.extend((r, c) for c in cols)
        cyc.extend((r, 0) for r in range(h - 1, 0, -1))
        return cyc
    if w % 2 == 0:
        return [(c, r) for (r, c) in grid_cycle(w, h)]
    path: list[Coord] = []
    for r in range(h):
        cols = range(w) if r % 2 == 0 else range(w - 1, -1, -1)
        path.extend((r, c) for c in cols)
    return path


def factor_pair(n: int, max_h: int, max_w: int) -> tuple[int, int]:
    """Factor ``n = h * w`` with ``h | max_h`` and ``w | max_w``, preferring
    the most square pair (minimal ``h + w``)."""
    best: tuple[int, int] | None = None
    for h in range(1, n + 1):
        if n % h:
            continue
        w = n // h
        if max_h % h or max_w % w:
            continue
        if best is None or h + w < sum(best):
            best = (h, w)
    if best is None:
        raise ValueError(f"cannot tile {n} devices into {max_h}x{max_w} mesh")
    return best


@dataclasses.dataclass
class Mapping:
    """Placement of ``dp`` TP groups x ``tp`` ranks onto a mesh."""

    topo: MeshTopology
    dp: int
    tp: int
    name: str
    # tp_groups[g] = device ids of group g in *ring order*.
    tp_groups: list[list[int]]
    # ftds[f] = device ids of FTD f (one member per TP group).
    ftds: list[list[int]]

    def __post_init__(self) -> None:
        n = self.topo.n_devices
        self.group_of = np.full(n, -1, dtype=np.int64)
        self.rank_of = np.full(n, -1, dtype=np.int64)
        self.ftd_of = np.full(n, -1, dtype=np.int64)
        for g, devs in enumerate(self.tp_groups):
            for r, d in enumerate(devs):
                self.group_of[d] = g
                self.rank_of[d] = r
        for f, devs in enumerate(self.ftds):
            for d in devs:
                self.ftd_of[d] = f
        if (self.group_of < 0).any():
            raise ValueError("every device must be in a TP group")
        if (self.ftd_of < 0).any():
            raise ValueError("every device must be in an FTD")

    def ring_hop_distances(self, g: int) -> list[int]:
        """Hop distance of every consecutive (cyclic) edge of group ``g``'s
        ring. The all-reduce step time scales with the max of these."""
        coords = [self.topo.coord(d) for d in self.tp_groups[g]]
        return [
            self.topo.hops(coords[i], coords[(i + 1) % len(coords)])
            for i in range(len(coords))
        ]

    def max_ring_hop(self) -> int:
        return max(max(self.ring_hop_distances(g)) for g in range(self.dp))

    def device_order(self) -> np.ndarray:
        """(dp, tp) array of device ids: the order that lays a ("data",
        "model") mesh onto the physical placement this mapping describes."""
        return np.array(self.tp_groups, dtype=np.int64)


def baseline_mapping(topo: MeshTopology, dp: int, tp: int) -> Mapping:
    """Contiguous-block placement (paper Fig. 8(b))."""
    if dp * tp != topo.n_devices:
        raise ValueError(f"dp*tp={dp * tp} != devices={topo.n_devices}")
    bh, bw = factor_pair(tp, topo.rows, topo.global_cols)
    grid_h, grid_w = topo.rows // bh, topo.global_cols // bw

    tp_groups: list[list[int]] = []
    for gr in range(grid_h):
        for gc in range(grid_w):
            ring = grid_cycle(bh, bw)
            tp_groups.append(
                [topo.device_id((gr * bh + r, gc * bw + c)) for (r, c) in ring]
            )
    ftds: list[list[int]] = []
    for r in range(bh):
        for c in range(bw):
            ftds.append(
                [
                    topo.device_id((gr * bh + r, gc * bw + c))
                    for gr in range(grid_h)
                    for gc in range(grid_w)
                ]
            )
    return Mapping(topo, dp, tp, "baseline", tp_groups, ftds)


def er_mapping(topo: MeshTopology, dp: int, tp: int) -> Mapping:
    """Entwined placement (Fig. 8(c)): compact disjoint FTD tiles."""
    if dp * tp != topo.n_devices:
        raise ValueError(f"dp*tp={dp * tp} != devices={topo.n_devices}")
    th, tw = factor_pair(dp, topo.rows, topo.global_cols)
    grid_h, grid_w = topo.rows // th, topo.global_cols // tw  # tile grid
    if grid_h * grid_w != tp:
        raise ValueError("tile grid does not match tp")

    tile_ring = grid_cycle(grid_h, grid_w)  # ring order over tiles
    tp_groups = []
    for a in range(th):
        for b in range(tw):
            tp_groups.append(
                [topo.device_id((t_r * th + a, t_c * tw + b)) for (t_r, t_c) in tile_ring]
            )
    ftds = []
    for t_r in range(grid_h):
        for t_c in range(grid_w):
            ftds.append(
                [
                    topo.device_id((t_r * th + a, t_c * tw + b))
                    for a in range(th)
                    for b in range(tw)
                ]
            )
    return Mapping(topo, dp, tp, "er", tp_groups, ftds)


def hierarchical_er_mapping(topo: MeshTopology, dp: int, tp: int) -> Mapping:
    """HER-Mapping for multi-wafer systems (Fig. 10(c)).

    Every wafer is ER-mapped with ``dp`` tiles whose members are the
    wafer-local ranks of each group; group ranks are striped across wafers
    so the inter-wafer all-gather runs on the border links. Alternate
    wafers' segments are reversed so each ring closes over the border.
    """
    if topo.n_wafers == 1:
        return er_mapping(topo, dp, tp)
    if dp * tp != topo.n_devices:
        raise ValueError(f"dp*tp={dp * tp} != devices={topo.n_devices}")
    if tp % topo.n_wafers:
        raise ValueError("tp must be divisible by the wafer count")
    wafer = MeshTopology(topo.rows, topo.cols, 1)
    local = er_mapping(wafer, dp, tp // topo.n_wafers)

    def shifted(d: int, w: int) -> int:
        r, c = wafer.coord(d)
        return topo.device_id((r, c + w * topo.cols))

    tp_groups: list[list[int]] = [[] for _ in range(dp)]
    for w in range(topo.n_wafers):
        for g in range(dp):
            seg = [shifted(d, w) for d in local.tp_groups[g]]
            tp_groups[g].extend(seg if w % 2 == 0 else seg[::-1])
    ftds = [[shifted(d, w) for d in f] for w in range(topo.n_wafers) for f in local.ftds]
    return Mapping(topo, dp, tp, "her", tp_groups, ftds)


MAPPINGS = {
    "baseline": baseline_mapping,
    "er": er_mapping,
    "her": hierarchical_er_mapping,
}
