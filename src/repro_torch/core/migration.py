"""Expert-migration decomposition into Local/Global hops (copy of
``repro.core.migration.decompose``; the analytical cold-link engine stays
with the simulator)."""

from __future__ import annotations

import dataclasses

from repro_torch.core.er_mapping import Mapping

Migration = tuple[int, int, int]  # (expert, src_device, dst_device)


@dataclasses.dataclass
class MigStep:
    kind: str            # "local" | "global"
    src: int
    dst: int
    nbytes: float


def decompose(
    mig: Migration, mapping: Mapping, expert_bytes: float
) -> list[MigStep]:
    """Split one expert migration into Local/Global steps (Fig. 11(d))."""
    _, src, dst = mig
    topo = mapping.topo
    f_src, f_dst = int(mapping.ftd_of[src]), int(mapping.ftd_of[dst])
    if f_src == f_dst:
        return [MigStep("local", src, dst, expert_bytes)]
    # Exit through the source-FTD member closest to the destination, enter
    # through the destination-FTD member closest to the source.
    dc, sc = topo.coord(dst), topo.coord(src)
    exit_d = min(mapping.ftds[f_src], key=lambda d: topo.hops(topo.coord(d), dc))
    entry_d = min(mapping.ftds[f_dst], key=lambda d: topo.hops(topo.coord(d), sc))
    steps: list[MigStep] = []
    if exit_d != src:
        steps.append(MigStep("local", src, exit_d, expert_bytes))
    steps.append(MigStep("global", exit_d, entry_d, expert_bytes))
    if entry_d != dst:
        steps.append(MigStep("local", entry_d, dst, expert_bytes))
    return steps
