"""TP-group / FTD placement (copy of ``repro.core.er_mapping``, cut to the
contiguous-block ``baseline_mapping`` the migration driver decomposes
against; the entwined mappings come with the analytical model)."""

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
    tp_groups: list[list[int]]
    ftds: list[list[int]]

    def __post_init__(self) -> None:
        n = self.topo.n_devices
        self.ftd_of = np.full(n, -1, dtype=np.int64)
        for f, devs in enumerate(self.ftds):
            for d in devs:
                self.ftd_of[d] = f
        if (self.ftd_of < 0).any():
            raise ValueError("every device must be in an FTD")


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
