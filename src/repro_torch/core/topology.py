"""Mesh / multi-wafer network topology model (copy of
``repro.core.topology``).

The paper's WSC platforms are 2-D meshes of dies; multi-WSC systems stitch
several wafers edge-to-edge through border connectors. This module provides
device coordinates, the directed nearest-neighbour links, dimension-ordered
(XY) routing and per-link traffic accumulation, the primitive every
collective and migration cost model is built on.

Wafers are laid out in a row: wafer w occupies columns [w*W, (w+1)*W).
Cross-wafer links exist between every pair of horizontally adjacent border
devices, matching the paper's "one-border cross-wafer bandwidth".
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import numpy as np

Coord = tuple[int, int]          # (row, col) in the global grid
Link = tuple[int, int]           # (src_device_id, dst_device_id), directed


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """A grid of devices: ``n_wafers`` wafers of ``rows x cols`` each.

    Device ids are row-major over the *global* grid of shape
    ``(rows, n_wafers * cols)``.
    """

    rows: int
    cols: int
    n_wafers: int = 1

    # -- basic geometry ------------------------------------------------

    @property
    def global_cols(self) -> int:
        return self.cols * self.n_wafers

    @property
    def n_devices(self) -> int:
        return self.rows * self.global_cols

    def device_id(self, coord: Coord) -> int:
        r, c = coord
        return r * self.global_cols + c

    def coord(self, device_id: int) -> Coord:
        return divmod(device_id, self.global_cols)

    def wafer_of(self, coord: Coord) -> int:
        return coord[1] // self.cols

    def coords(self) -> Iterator[Coord]:
        for r in range(self.rows):
            for c in range(self.global_cols):
                yield (r, c)

    def is_cross_wafer(self, link: Link) -> bool:
        (_, c1), (_, c2) = self.coord(link[0]), self.coord(link[1])
        return c1 // self.cols != c2 // self.cols

    # -- links -----------------------------------------------------------

    @functools.cached_property
    def links(self) -> list[Link]:
        """All directed nearest-neighbour links, in a fixed order."""
        out: list[Link] = []
        for r in range(self.rows):
            for c in range(self.global_cols):
                u = self.device_id((r, c))
                if c + 1 < self.global_cols:
                    v = self.device_id((r, c + 1))
                    out.extend([(u, v), (v, u)])
                if r + 1 < self.rows:
                    v = self.device_id((r + 1, c))
                    out.extend([(u, v), (v, u)])
        return out

    @functools.cached_property
    def link_index(self) -> dict[Link, int]:
        return {l: i for i, l in enumerate(self.links)}

    @property
    def n_links(self) -> int:
        return len(self.links)

    # -- distance / routing ------------------------------------------------

    def hops(self, a: Coord, b: Coord) -> int:
        """Manhattan hop count between two devices (XY route length)."""
        return abs(a[0] - b[0]) + abs(a[1] - b[1])

    def route(self, src: Coord, dst: Coord) -> list[Link]:
        """Dimension-ordered (X then Y) route as a list of directed links."""
        path: list[Link] = []
        r, c = src
        step = 1 if dst[1] > c else -1
        while c != dst[1]:
            path.append((self.device_id((r, c)), self.device_id((r, c + step))))
            c += step
        step = 1 if dst[0] > r else -1
        while r != dst[0]:
            path.append((self.device_id((r, c)), self.device_id((r + step, c))))
            r += step
        return path

    # -- traffic accounting --------------------------------------------------

    def link_loads(self, traffic: dict[tuple[int, int], float]) -> np.ndarray:
        """Accumulate a traffic matrix onto per-link byte counts.

        ``traffic`` maps (src_device_id, dst_device_id) -> bytes. Routes are
        XY-deterministic. Returns an array of shape (n_links,).
        """
        loads = np.zeros(self.n_links)
        idx = self.link_index
        for (s, d), vol in traffic.items():
            if s == d or vol == 0.0:
                continue
            for link in self.route(self.coord(s), self.coord(d)):
                loads[idx[link]] += vol
        return loads

    def max_hops(self, traffic: dict[tuple[int, int], float]) -> int:
        """Longest route length among non-zero traffic entries."""
        h = 0
        for (s, d), vol in traffic.items():
            if s != d and vol > 0.0:
                h = max(h, self.hops(self.coord(s), self.coord(d)))
        return h

    def load_grid(self, loads: np.ndarray) -> dict[Link, float]:
        """Per-link loads keyed by link, for the cold/hot link analysis of
        the paper's Section V."""
        return {l: float(loads[i]) for i, l in enumerate(self.links)}
