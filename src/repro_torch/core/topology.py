"""Mesh topology geometry (numpy-free copy of ``repro.core.topology``, cut
to the device coordinates and hop distances the migration decomposition
reads; link-load accounting stays with the analytical model)."""

from __future__ import annotations

import dataclasses

Coord = tuple[int, int]          # (row, col) in the global grid


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """A grid of devices: ``n_wafers`` wafers of ``rows x cols`` each.

    Device ids are row-major over the *global* grid of shape
    ``(rows, n_wafers * cols)``.
    """

    rows: int
    cols: int
    n_wafers: int = 1

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

    def hops(self, a: Coord, b: Coord) -> int:
        """Manhattan hop count between two devices (XY route length)."""
        return abs(a[0] - b[0]) + abs(a[1] - b[1])
