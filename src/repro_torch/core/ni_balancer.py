"""Non-invasive Balancer (copy of ``repro.core.ni_balancer``, cut to what
the serving slice calls): the Eq. 2 trigger and the paper's Algorithm 1
over the shared :class:`~repro_torch.parallel.placement.PlacementTable`.
Evacuation, revival and the greedy baseline come with the fault-tolerance
slice."""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.migration import Migration
from repro_torch.parallel.placement import PlacementTable


@dataclasses.dataclass
class BalancerState:
    """Expert placement for one MoE layer, read through the shared table.
    ``replicas`` is the planning view (committed + in-flight), so Algorithm
    1 never re-plans a migration whose slices are still landing."""

    n_experts: int
    n_devices: int
    slots_per_device: int                      # native + shadow capacity
    table: PlacementTable
    load_ema: np.ndarray                       # Load_e, EMA of token counts
    ema_decay: float = 0.8
    dead: set[int] = dataclasses.field(default_factory=set)
    slowdown: np.ndarray | None = None

    @property
    def replicas(self) -> list[list[int]]:
        return self.table.all_replica_devices()

    def slots_used(self) -> np.ndarray:
        return self.table.slots_used().astype(np.int64)

    def observe(self, loads: np.ndarray) -> None:
        """Fold one iteration's per-expert token counts into the EMA."""
        total = loads.sum()
        if total > 0:
            self.load_ema = (
                self.ema_decay * self.load_ema
                + (1 - self.ema_decay) * loads / total
            )


def imbalance_degree(loads_per_layer: Sequence[np.ndarray]) -> float:
    """Σ_i (max(load_i) - mean(load_i)) / mean(load_i) over layers."""
    total = 0.0
    for loads in loads_per_layer:
        mu = loads.mean()
        if mu > 0:
            total += (loads.max() - mu) / mu
    return total


def should_trigger(
    loads_per_layer: Sequence[np.ndarray],
    alpha: float,
    dt_since_migration: float,
    beta: float = 0.0,
) -> bool:
    """Paper Eq. 2 (``beta = 0`` for the non-invasive balancer)."""
    return imbalance_degree(loads_per_layer) > alpha and dt_since_migration > beta


def topology_aware_balance(
    state: BalancerState,
    distance: Callable[[int, int], float],
    max_migrations: int | None = None,
) -> list[Migration]:
    """Paper Algorithm 1: replicate the hottest device's most loaded
    (per-replica) expert to the topologically nearest device that stays
    below the current peak heat; stop when no such device has a free slot."""
    migs: list[Migration] = []
    replicas = [list(r) for r in state.replicas]
    used = state.slots_used().copy()
    load = state.load_ema

    def heats() -> np.ndarray:
        h = np.zeros(state.n_devices)
        for e, devs in enumerate(replicas):
            share = load[e] / len(devs)
            for d in devs:
                h[d] += share
        if state.slowdown is not None:
            h = h * state.slowdown
        for d in state.dead:
            h[d] = np.inf
        return h

    while max_migrations is None or len(migs) < max_migrations:
        heat = heats()
        # Dead devices (infinite heat) must not win the hottest argmax.
        finite = np.where(np.isfinite(heat), heat, -np.inf)
        hottest = int(np.argmax(finite))
        if not np.isfinite(heat[hottest]):
            break
        on_hot = [e for e in range(state.n_experts) if hottest in replicas[e]]
        if not on_hot:
            break
        src_e = max(on_hot, key=lambda e: load[e] / len(replicas[e]))
        new_share = load[src_e] / (len(replicas[src_e]) + 1)
        cold = [
            d
            for d in range(state.n_devices)
            if d not in replicas[src_e]
            and d not in state.dead
            and heat[d] + new_share < heat[hottest]
            and used[d] < state.slots_per_device
        ]
        if not cold:
            break
        dst = min(cold, key=lambda d: distance(hottest, d))
        replicas[src_e].append(dst)
        used[dst] += 1
        migs.append((src_e, hottest, dst))
    return migs
