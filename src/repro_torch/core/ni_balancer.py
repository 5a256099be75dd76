"""Non-invasive Balancer (copy of ``repro.core.ni_balancer``): the Eq. 2
trigger, the paper's Algorithm 1 and the EPLB-style greedy baseline over the
shared :class:`~repro_torch.parallel.placement.PlacementTable`, and the
fault-tolerance companions: evacuation after a device death, revival of a
blank device, replica pruning and the per-replica token split."""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.migration import Migration
from repro_torch.parallel.placement import PlacementError, PlacementTable


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
    # Straggler penalty: heat multiplier per device (EMA of step-time ratio
    # vs median; 1.0 = healthy).
    slowdown: np.ndarray | None = None

    @classmethod
    def initial(
        cls, n_experts: int, n_devices: int, slots_per_device: int
    ) -> "BalancerState":
        if n_experts > n_devices * slots_per_device:
            raise ValueError("not enough slots for native experts")
        table = PlacementTable.round_robin(n_experts, n_devices, slots_per_device)
        return cls(
            n_experts=n_experts,
            n_devices=n_devices,
            slots_per_device=slots_per_device,
            table=table,
            load_ema=np.ones(n_experts) / n_experts,
        )

    @property
    def replicas(self) -> list[list[int]]:
        """replicas[e] = devices hosting expert e (first = native home),
        in-flight replicas included."""
        return self.table.all_replica_devices()

    def num_replicas(self) -> np.ndarray:
        return np.array([len(r) for r in self.replicas])

    def device_experts(self) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in range(self.n_devices)]
        for e, devs in enumerate(self.replicas):
            for d in devs:
                out[d].append(e)
        return out

    def slots_used(self) -> np.ndarray:
        return self.table.slots_used().astype(np.int64)

    def heats(self) -> np.ndarray:
        """Heat_d = Σ_e on d Load_e / Num_e, with straggler penalty; a dead
        device's heat is infinite."""
        return _heats(self, self.replicas)

    def observe(self, loads: np.ndarray) -> None:
        """Fold one iteration's per-expert token counts into the EMA."""
        total = loads.sum()
        if total > 0:
            self.load_ema = (
                self.ema_decay * self.load_ema
                + (1 - self.ema_decay) * loads / total
            )

    def device_token_share(self) -> np.ndarray:
        """Expected fraction of dispatched tokens landing on each device,
        mean-normalised."""
        heat = _heats(self, self.replicas, straggle=False, dead=False)
        mean = heat.mean() if len(heat) else 1.0
        return heat / max(mean, 1e-12)

    def mark_dead(self, device: int) -> None:
        self.dead.add(device)

    def revive(self, device: int) -> None:
        """Re-admit a dead device into planning: finite heat again, straggler
        penalty reset. Placement is untouched: the device re-enters routing
        only when replica copies commit through the migration path."""
        self.dead.discard(device)
        if self.slowdown is not None:
            self.slowdown[device] = 1.0

    def drop_device(self, device: int) -> int:
        """Forget a dead device's replicas wherever another survives (run
        ``evacuate`` first so no sole copy sits there). Returns the number
        of experts that dropped a replica."""
        return self.table.drop_device(device)

    def apply(self, mig: Migration) -> None:
        """Commit a planned migration into the shared table at once
        (simulation, evacuation); the live serving path goes through the
        MigrationDriver's reserve -> slices -> commit."""
        e, src, dst = mig
        if src not in self.replicas[e]:
            raise PlacementError(
                f"migration {mig}: source device {src} hosts no replica "
                f"of expert {e}"
            )
        if self.table.apply(e, dst) is None:
            raise PlacementError(
                f"migration {mig}: destination {dst} cannot take a replica "
                f"of expert {e} (no free slot, already hosting, or replica "
                f"cap)"
            )


def _heats(state: BalancerState, replicas: list[list[int]], straggle: bool = True,
           dead: bool = True) -> np.ndarray:
    """Device heats over ``replicas`` (the state's own lists, or a planning
    copy): Σ_e on d Load_e / Num_e, times the straggler penalty, infinite
    on dead devices."""
    h = np.zeros(state.n_devices)
    for e, devs in enumerate(replicas):
        share = state.load_ema[e] / len(devs)
        for d in devs:
            h[d] += share
    if straggle and state.slowdown is not None:
        h = h * state.slowdown
    if dead:
        for d in state.dead:
            h[d] = np.inf
    return h


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

    while max_migrations is None or len(migs) < max_migrations:
        heat = _heats(state, replicas)
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


def greedy_balance(
    state: BalancerState,
    max_migrations: int | None = None,
) -> list[Migration]:
    """EPLB-style baseline: hottest expert -> globally coldest device,
    ignoring topology (and the straggler penalty, as the reference does)."""
    migs: list[Migration] = []
    replicas = [list(r) for r in state.replicas]
    used = state.slots_used().copy()
    load = state.load_ema

    while max_migrations is None or len(migs) < max_migrations:
        heat = _heats(state, replicas, straggle=False)
        finite = np.where(np.isfinite(heat), heat, -np.inf)
        hottest = int(np.argmax(finite))   # dead (inf) devices can't win
        if not np.isfinite(heat[hottest]):
            break
        on_hot = [e for e in range(state.n_experts) if hottest in replicas[e]]
        if not on_hot:
            break
        src_e = max(on_hot, key=lambda e: load[e] / len(replicas[e]))
        new_share = load[src_e] / (len(replicas[src_e]) + 1)
        dst = None
        for d in np.argsort(heat):
            d = int(d)
            if (
                d not in replicas[src_e]
                and d not in state.dead
                and used[d] < state.slots_per_device
                and heat[d] + new_share < heat[hottest]
            ):
                dst = d
                break
        if dst is None:
            break
        replicas[src_e].append(dst)
        used[dst] += 1
        migs.append((src_e, hottest, dst))
    return migs


def prune_replicas(state: BalancerState, frac: float = 0.5) -> int:
    """Reclaim shadow slots: drop the last replica of any expert whose
    per-replica load fell below ``frac`` of the mean finite device heat.
    Returns the number of reclaimed slots."""
    heats = state.heats()
    finite = heats[np.isfinite(heats)]
    mean_heat = finite.mean() if len(finite) else 0.0
    n = 0
    table = state.table
    for e in range(state.n_experts):
        while (
            int(table.n_replicas[e]) > 1
            and state.load_ema[e] / int(table.n_replicas[e]) < frac * mean_heat
        ):
            table.remove_replica(e, int(table.n_replicas[e]) - 1)
            n += 1
    return n


def evacuate(
    state: BalancerState,
    device: int,
    distance: Callable[[int, int], float],
) -> list[Migration]:
    """Availability evacuation after a device failure: every expert whose
    only live home is ``device`` gets a replica on the nearest live device
    with a free slot, committed into the table at once."""
    state.mark_dead(device)
    used = state.slots_used()
    migs: list[Migration] = []
    for e in range(state.n_experts):
        if any(d not in state.dead for d in state.replicas[e]):
            continue
        candidates = [
            d
            for d in range(state.n_devices)
            if d not in state.dead and used[d] < state.slots_per_device
        ]
        if not candidates:
            break
        dst = min(candidates, key=lambda d: distance(device, d))
        mig = (e, device, dst)
        state.apply(mig)
        used[dst] += 1
        migs.append(mig)
    return migs


def revival_plan(
    state: BalancerState,
    device: int,
    distance: Callable[[int, int], float],
    max_seed: int | None = None,
) -> list[Migration]:
    """Seed a just-revived (blank-HBM) device with expert replicas: the
    expert with the highest per-replica load first, from its nearest live
    host, as long as the move keeps the device below the current peak heat.
    ``state.revive(device)`` must already have run; the plan goes to the
    stepped migration driver, so nothing routes to ``device`` until each
    copy's last slice commits."""
    if device in state.dead:
        raise PlacementError(f"device {device} is still marked dead")
    migs: list[Migration] = []
    replicas = [list(r) for r in state.replicas]
    used = state.slots_used().copy()
    load = state.load_ema

    while used[device] < state.slots_per_device:
        if max_seed is not None and len(migs) >= max_seed:
            break
        heat = _heats(state, replicas)
        peak = float(np.max(np.where(np.isfinite(heat), heat, -np.inf)))
        cands = [
            e
            for e in range(state.n_experts)
            if device not in replicas[e]
            and len(replicas[e]) < state.table.r_max
            and any(d not in state.dead for d in replicas[e])
            and heat[device] + load[e] / (len(replicas[e]) + 1) < peak
        ]
        if not cands:
            break
        e = max(cands, key=lambda e: load[e] / len(replicas[e]))
        live = [d for d in replicas[e] if d not in state.dead]
        src = min(live, key=lambda d: distance(d, device))
        replicas[e].append(device)
        used[device] += 1
        migs.append((e, src, device))
    return migs


def replica_shares(state: BalancerState) -> list[np.ndarray]:
    """Per-expert token split across its replicas (uniform: each replica
    takes 1/Num_e of the expert's traffic)."""
    return [np.full(len(r), 1.0 / len(r)) for r in state.replicas]
