"""Elastic scaling and failure-handling glue (PyTorch port of
``repro.runtime.elastic``).

* ``restore_elastic`` restores the latest checkpoint onto any mesh: arrays
  come back on the host and each is placed by the caller's layout policy
  (``sharding_fn``; :mod:`repro_torch.parallel.sharding` says which slice
  of a dimension a rank keeps), so the previous run's device count does not
  matter.
* ``StepTimer`` tracks per-step wall times and flags outliers (over 1.5x
  the EMA) so the caller can feed ``Server.report_step_time``.
* ``drill_failure`` runs death, rebalance and, optionally, revival through
  the serving path itself (``Server.mark_dead``, ``apply_plan``,
  ``revive``), driving the stepped migrations on idle ticks.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.ni_balancer import topology_aware_balance
from repro_torch.runtime.checkpoint import CheckpointManager


def restore_elastic(mgr: CheckpointManager, template, mesh, sharding_fn):
    """Restore the latest checkpoint onto ``mesh``. ``sharding_fn(mesh,
    template)`` returns a tree matching ``template`` of callables, each
    taking its host leaf to this rank's tensor on its device. Returns
    ``(tree, meta)``."""
    shardings = sharding_fn(mesh, template) if mesh is not None else None
    return mgr.restore(template, shardings=shardings)


class StepTimer:
    """EMA step timer with straggler detection."""

    def __init__(self, alpha: float = 0.9, threshold: float = 1.5):
        self.alpha = alpha
        self.threshold = threshold
        self.ema: float | None = None
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dt = time.monotonic() - self._t0
        self.last = dt
        self.ema = dt if self.ema is None else self.alpha * self.ema + (1 - self.alpha) * dt

    @property
    def is_straggling(self) -> bool:
        return self.ema is not None and self.last > self.threshold * self.ema

    @property
    def ratio(self) -> float:
        if self.ema is None or self.ema == 0:
            return 1.0
        return float(self.last / self.ema)


def _drain_all(server, limit: int = 256) -> int:
    """Tick the stepped migration driver on idle time until nothing is in
    flight (a drill has no decode loop for the slices to ride). Advances
    ``server.t``. Returns the ticks consumed."""
    if server.driver is None:
        return 0
    ticks = 0
    while server.driver.pending and ticks < limit:
        server.drain_migrations()
        server.t += 1
        ticks += 1
    # one final boundary: commit what the last slice completed
    server.drain_migrations()
    return ticks


def drill_failure(server, device: int, revive: bool = False) -> dict:
    """Fault-injection drill: kill ``device``, rebalance the survivors and,
    with ``revive``, bring it back, all through the public serving path.
    Reports the peak heat before and after, whether every expert kept a
    live replica, and with ``revive`` the revival's migrations, the ticks
    until they all committed and the replicas the device then holds."""
    state = server.state
    if state is None:
        return {"supported": False}
    before = float(np.max(state.heats()[np.isfinite(state.heats())]))
    plan = server.mark_dead(device)
    migs = topology_aware_balance(state, server.distance)
    applied = server.apply_plan(migs)
    _drain_all(server)
    heats = state.heats()
    after = float(np.max(heats[np.isfinite(heats)]))
    evacuated = all(
        any(d not in state.dead for d in state.replicas[e])
        for e in range(state.n_experts)
    )
    out = {
        "supported": True,
        "migrations": len(plan) + applied,
        "peak_before": before,
        "peak_after": after,
        "evacuated": evacuated,
    }
    if revive:
        rplan = server.revive(device)
        ticks = _drain_all(server)
        heats = state.heats()
        out["revival_migrations"] = len(rplan)
        out["revival_recovery_ticks"] = ticks
        out["revival_replicas"] = sum(device in devs for devs in state.replicas)
        out["peak_after_revival"] = float(np.max(heats[np.isfinite(heats)]))
    return out
