"""Expert-migration decomposition and cold-link scheduling (copy of
``repro.core.migration``; paper Section V-A).

Under ER-Mapping the hot/cold link sets of the two collectives are
complementary: the all-reduce keeps FTD-*connection* links busy (ring
edges) while intra-FTD links idle; the all-to-all is confined inside FTDs
while inter-FTD links idle. A migration therefore decomposes into

    Local (intra-FTD, runs during the attention/all-reduce phase)
  -> Global (inter-FTD, runs during the MoE/all-to-all phase)
  -> Local (intra-FTD)

steps that ride whatever per-link slack the concurrent collective leaves.
``decompose`` is shared by the serving runtime's stepped migration driver
and by :class:`MigrationEngine`, the analytic model's executor:

* ``noninvasive``: steps consume only link *slack*
  (``phase_time * bw - collective_load``); zero exposed latency by
  construction, but a migration may take several iterations to land.
* ``invasive``: the migration interrupts inference; its full Eq. 1 route
  time is exposed on the critical path (the EPLB-style baseline).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.comm_model import _route_time
from repro_torch.core.er_mapping import Mapping
from repro_torch.core.hardware import PlatformSpec

Migration = tuple[int, int, int]  # (expert, src_device, dst_device)


@dataclasses.dataclass
class MigStep:
    kind: str            # "local" | "global"
    src: int
    dst: int
    nbytes: float
    sent: float = 0.0

    @property
    def done(self) -> bool:
        return self.sent >= self.nbytes - 1e-9


@dataclasses.dataclass
class InFlight:
    mig: Migration
    steps: list[MigStep]
    step_idx: int = 0

    @property
    def done(self) -> bool:
        return self.step_idx >= len(self.steps)

    @property
    def current(self) -> MigStep:
        return self.steps[self.step_idx]


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


class MigrationEngine:
    """Executes migrations across iterations; accounts exposed latency."""

    def __init__(
        self,
        mapping: Mapping,
        platform: PlatformSpec,
        expert_bytes: float,
        mode: str = "noninvasive",
    ):
        if mode not in ("noninvasive", "invasive"):
            raise ValueError(f"unknown migration mode {mode!r}")
        self.mapping = mapping
        self.platform = platform
        self.expert_bytes = expert_bytes
        self.mode = mode
        self.in_flight: list[InFlight] = []
        self.completed: list[Migration] = []
        self.total_exposed = 0.0

    def submit(self, migs: list[Migration]) -> float:
        """Queue migrations. Invasive mode returns the exposed stall time
        (inference interrupted while weights move, Eq. 1 route time,
        serialized); non-invasive returns 0 and the engine drains the queue
        on subsequent iterations' cold links."""
        if self.mode == "invasive":
            exposed = 0.0
            for m in migs:
                _, src, dst = m
                exposed += _route_time(
                    self.mapping.topo, self.platform, src, dst, self.expert_bytes
                )
                self.completed.append(m)
            self.total_exposed += exposed
            return exposed
        for m in migs:
            self.in_flight.append(
                InFlight(m, decompose(m, self.mapping, self.expert_bytes))
            )
        return 0.0

    def _phase_budgets(
        self, phase_time: float, collective_loads: np.ndarray | None
    ) -> np.ndarray:
        """Per-link byte budget left over by the concurrent collective."""
        topo = self.mapping.topo
        bw = np.empty(topo.n_links)
        for i, l in enumerate(topo.links):
            spec = self.platform.inter if topo.is_cross_wafer(l) else self.platform.intra
            bw[i] = spec.bw
        budget = phase_time * bw
        if collective_loads is not None:
            budget = np.maximum(budget - collective_loads, 0.0)
        return budget

    def _drain(self, kind: str, budget: np.ndarray) -> None:
        topo = self.mapping.topo
        idx = topo.link_index
        for fl in self.in_flight:
            if fl.done:
                continue
            step = fl.current
            if step.kind != kind:
                continue
            links = [idx[l] for l in topo.route(topo.coord(step.src), topo.coord(step.dst))]
            if not links:
                step.sent = step.nbytes
            else:
                avail = float(min(budget[li] for li in links))
                send = min(avail, step.nbytes - step.sent)
                if send <= 0:
                    continue
                for li in links:
                    budget[li] -= send
                step.sent += send
            while not fl.done and fl.current.done:
                fl.step_idx += 1

    def step_iteration(
        self,
        attn_phase_time: float,
        moe_phase_time: float,
        ar_loads: np.ndarray | None = None,
        a2a_loads: np.ndarray | None = None,
    ) -> list[Migration]:
        """Advance all in-flight migrations by one inference iteration.

        Local steps ride all-reduce slack during the attention phase;
        Global steps ride all-to-all slack during the MoE phase. Returns
        migrations that completed this iteration.
        """
        if self.mode == "invasive" or not self.in_flight:
            return []
        self._drain("local", self._phase_budgets(attn_phase_time, ar_loads))
        self._drain("global", self._phase_budgets(moe_phase_time, a2a_loads))

        done = [fl.mig for fl in self.in_flight if fl.done]
        self.completed.extend(done)
        self.in_flight = [fl for fl in self.in_flight if not fl.done]
        return done

    @property
    def pending(self) -> int:
        return len(self.in_flight)
