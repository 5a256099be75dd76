"""Fault-injection harness for the serving loop (copy of
``repro.runtime.faults``; numpy only).

A :class:`FaultPlan` is a deterministic schedule of :class:`Fault` events,
keyed by scheduler step. The :class:`repro_torch.runtime.scheduler.
RequestScheduler` drains the plan at the start of each tick and degrades
gracefully: a fault fails or requeues only the requests it touches, the
step loop never crashes, and (because preempted work is recomputed from the
prompt) the surviving requests' outputs stay bit-identical to a fault-free
run.

Fault kinds
-----------

* ``device_death``  — ``Server.mark_dead(device)``: evacuate orphaned
  experts (state + physical weight rows), drop the device from routing.
* ``straggler``     — ``Server.report_step_time(device, ratio)``: folds a
  measured slowdown into the balancer heats, draining load away.
* ``pool_pressure`` — steals ``pages`` pages from the ``PagePool`` (an
  external tenant / fragmentation stand-in), forcing admission backpressure
  and preemption.
* ``pool_release``  — returns ``pages`` stolen pages (all, if fewer held).
* ``nan_logits``    — poisons the chosen batch ``slots``' logits with NaN
  for one step; the scheduler requeues the request for recompute instead
  of emitting garbage tokens.
* ``device_revival`` — ``Server.revive(device)``: re-admits a repaired
  device with blank HBM; replica copies stream back through the stepped
  migration driver.
* ``crash_restart`` — a simulated host crash: the scheduler snapshots its
  state (the end of the previous tick) and raises :class:`SimulatedCrash`
  before doing any work this tick; the harness rebuilds a fresh server and
  scheduler from the snapshot (``snapshot.restore_scheduler``) and serves
  on.

``FaultPlan.chaos`` builds a seeded random plan: one device death, a
straggler report, a pool-pressure window, and a NaN step, plus, with
``revive=True``, a revival of the killed device a few steps after its
death. It draws exactly as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEVICE_DEATH = "device_death"
STRAGGLER = "straggler"
POOL_PRESSURE = "pool_pressure"
POOL_RELEASE = "pool_release"
NAN_LOGITS = "nan_logits"
DEVICE_REVIVAL = "device_revival"
CRASH_RESTART = "crash_restart"

KINDS = (
    DEVICE_DEATH,
    STRAGGLER,
    POOL_PRESSURE,
    POOL_RELEASE,
    NAN_LOGITS,
    DEVICE_REVIVAL,
    CRASH_RESTART,
)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected event at scheduler step ``step``."""

    step: int
    kind: str
    device: int = 0          # device_death / straggler / device_revival
    ratio: float = 1.0       # straggler step-time ratio
    pages: int = 0           # pool_pressure / pool_release page count
    slots: tuple[int, ...] = ()  # nan_logits targets; () = every live slot
    path: str = ""           # crash_restart snapshot destination ("" = memory)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")


class FaultPlan:
    """An immutable, step-indexed schedule of faults."""

    def __init__(self, faults: tuple | list = ()):
        self.faults = tuple(sorted(faults, key=lambda f: (f.step, f.kind)))
        self._by_step: dict[int, list[Fault]] = {}
        for f in self.faults:
            self._by_step.setdefault(f.step, []).append(f)

    def at(self, step: int) -> tuple:
        """Faults firing at ``step`` (deterministic order)."""
        return tuple(self._by_step.get(step, ()))

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.faults)!r})"

    @classmethod
    def chaos(
        cls,
        seed: int,
        n_steps: int,
        n_devices: int = 0,
        pressure_pages: int = 0,
        nan_slots: tuple[int, ...] = (),
        straggler_ratio: float = 3.0,
        revive: bool = False,
    ) -> "FaultPlan":
        """Seeded random chaos: one device death (when ``n_devices`` > 1 —
        device 0 is spared so native experts keep a live anchor in tiny
        topologies), one straggler report, one pool-pressure window of
        ``pressure_pages`` pages, and one NaN-logits step on ``nan_slots``.
        With ``revive=True``, the killed device comes back (blank HBM) a
        few steps after its death. Deterministic in ``seed``; the revival
        draw happens after all others, so ``revive=False`` plans are
        byte-identical to pre-revival versions of this helper."""
        rng = np.random.default_rng(seed)
        span = max(n_steps, 8)
        faults = []
        death = None
        if n_devices > 1:
            death = Fault(
                step=int(rng.integers(1, span)),
                kind=DEVICE_DEATH,
                device=int(rng.integers(1, n_devices)),
            )
            faults.append(death)
            faults.append(
                Fault(
                    step=int(rng.integers(1, span)),
                    kind=STRAGGLER,
                    device=int(rng.integers(0, n_devices)),
                    ratio=straggler_ratio,
                )
            )
        if pressure_pages > 0:
            start = int(rng.integers(1, span))
            stop = int(rng.integers(start + 1, start + span))
            faults.append(
                Fault(step=start, kind=POOL_PRESSURE, pages=pressure_pages)
            )
            faults.append(
                Fault(step=stop, kind=POOL_RELEASE, pages=pressure_pages)
            )
        if nan_slots:
            faults.append(
                Fault(
                    step=int(rng.integers(1, span)),
                    kind=NAN_LOGITS,
                    slots=tuple(nan_slots),
                )
            )
        if revive and death is not None:
            faults.append(
                Fault(
                    step=death.step + int(rng.integers(2, max(3, span // 2))),
                    kind=DEVICE_REVIVAL,
                    device=death.device,
                )
            )
        return cls(faults)


class SimulatedCrash(Exception):
    """Raised by the scheduler when a ``crash_restart`` fault fires. Carries
    the snapshot of the end of the previous tick (also written to ``path``
    when one was given), from which a fresh process rebuilds the server and
    the scheduler and resumes."""

    def __init__(self, step: int, snapshot, path: str = ""):
        super().__init__(f"simulated crash at scheduler step {step}")
        self.step = step
        self.snapshot = snapshot
        self.path = path
