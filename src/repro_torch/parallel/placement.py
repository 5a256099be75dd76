"""The one placement table, from balancer to device (copy of
``repro.parallel.placement``).

Two views, one commit point:

* **routing view** (:meth:`device_view`) — the *committed* ``(slot_of,
  n_replicas)`` pair handed to the decode step as int32 tensors on the
  server's device. It changes only inside :meth:`commit` /
  :meth:`drop_device` / :meth:`remove_replica`, which the serving loop
  calls at decode-step boundaries: that is the atomic swap. A replica
  being copied slice-by-slice is *pending* and invisible here.
* **planning view** (:meth:`replica_devices`, :meth:`slots_used`,
  :meth:`free_slot`) — committed **plus pending** replicas, so the balancer
  does not re-plan an in-flight migration and two migrations never share a
  reserved slot.

Conventions (shared with ``collectives.choose_slots``): ``slot_of`` is
``(n_experts, r_max)`` int32, row ``e``'s live entries are
``slot_of[e, :n_replicas[e]]`` and the inert tail columns point at column
0; slot ``s`` lives on device ``s // slots_per_device``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PlacementError", "PlacementTable"]


class PlacementError(ValueError):
    """A placement mutation that would corrupt the table."""


class PlacementTable:
    def __init__(
        self,
        n_experts: int,
        n_slots: int,
        slots_per_device: int,
        slot_of: np.ndarray,
        n_replicas: np.ndarray,
    ):
        if n_slots % slots_per_device:
            raise PlacementError(
                f"n_slots={n_slots} not a multiple of "
                f"slots_per_device={slots_per_device}"
            )
        self.n_experts = int(n_experts)
        self.n_slots = int(n_slots)
        self.slots_per_device = int(slots_per_device)
        self.n_devices = self.n_slots // self.slots_per_device
        self.slot_of = np.array(slot_of, dtype=np.int32)
        self.n_replicas = np.array(n_replicas, dtype=np.int32)
        if self.slot_of.shape[0] != self.n_experts:
            raise PlacementError(
                f"slot_of rows {self.slot_of.shape[0]} != "
                f"n_experts {self.n_experts}"
            )
        self._pending: list[tuple[int, int]] = []
        # Monotonic commit counter; bumps whenever the routing view changes.
        self.version = 0
        self._device_view: dict[torch.device, tuple] = {}

    # -- constructors --------------------------------------------------------

    @classmethod
    def uniform(
        cls, n_experts: int, n_slots: int,
        slots_per_device: int | None = None, r_max: int = 4,
    ) -> "PlacementTable":
        """Expert e -> slot e (native homes), one replica each."""
        slot_of = np.zeros((n_experts, r_max), dtype=np.int32)
        slot_of[:] = (np.arange(n_experts) % n_slots)[:, None]
        n_replicas = np.ones(n_experts, dtype=np.int32)
        return cls(n_experts, n_slots, slots_per_device or n_slots,
                   slot_of, n_replicas)

    @classmethod
    def tiled(
        cls, n_experts: int, n_rows: int, n_slots: int,
        slots_per_device: int | None = None, r_max: int = 4,
    ) -> "PlacementTable":
        """Placement consistent with tiled slot weights: slot ``s`` holds
        weight row ``s % n_rows``, so expert ``e`` gets a replica at every
        slot with ``s % n_rows == e``. ``r_max`` grows to fit them."""
        if not (n_experts <= n_rows <= n_slots):
            raise PlacementError(
                f"need n_experts <= n_rows <= n_slots, got "
                f"({n_experts}, {n_rows}, {n_slots})"
            )
        r_max = max(r_max, -(-n_slots // n_rows))
        slot_of = np.zeros((n_experts, r_max), dtype=np.int32)
        n_replicas = np.zeros(n_experts, dtype=np.int32)
        for e in range(n_experts):
            reps = list(range(e, n_slots, n_rows))
            n_replicas[e] = len(reps)
            for r in range(r_max):
                slot_of[e, r] = reps[min(r, len(reps) - 1)]
        return cls(n_experts, n_slots, slots_per_device or n_slots,
                   slot_of, n_replicas)

    @classmethod
    def round_robin(
        cls, n_experts: int, n_devices: int, slots_per_device: int,
        r_max: int | None = None,
    ) -> "PlacementTable":
        """Expert e -> device ``e % n_devices`` (the balancer's initial
        layout), first-fit slot within the device."""
        if n_experts > n_devices * slots_per_device:
            raise PlacementError(
                f"{n_experts} experts need more than "
                f"{n_devices}x{slots_per_device} slots"
            )
        r_max = r_max or max(4, n_devices)
        slot_of = np.zeros((n_experts, r_max), dtype=np.int32)
        e = np.arange(n_experts)
        slot_of[:] = ((e % n_devices) * slots_per_device + e // n_devices)[
            :, None
        ]
        n_replicas = np.ones(n_experts, dtype=np.int32)
        return cls(n_experts, n_devices * slots_per_device,
                   slots_per_device, slot_of, n_replicas)

    # -- routing view (committed only) ---------------------------------------

    @property
    def r_max(self) -> int:
        return self.slot_of.shape[1]

    def device_view(self, device: str | torch.device = "cpu"):
        """The committed ``(slot_of, n_replicas)`` as int32 tensors on
        ``device``. Cached per device; rebuilt only after a commit bumps
        :attr:`version`, so between commits the decode step reads the
        identical tensors (the atomic-swap contract)."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        view = self._device_view.get(dev)
        if view is None:
            view = (
                torch.as_tensor(self.slot_of, dtype=torch.int32).to(dev),
                torch.as_tensor(self.n_replicas, dtype=torch.int32).to(dev),
            )
            self._device_view[dev] = view
        return view

    def _bump(self) -> None:
        self.version += 1
        self._device_view = {}

    def device_of(self, slot: int) -> int:
        return int(slot) // self.slots_per_device

    def _live(self) -> np.ndarray:
        return np.arange(self.r_max)[None, :] < self.n_replicas[:, None]

    def owner_of_slots(self) -> np.ndarray:
        """Expert committed to each physical slot, ``-1`` for free slots."""
        owner = np.full(self.n_slots, -1, dtype=np.int64)
        live = self._live()
        experts = np.broadcast_to(
            np.arange(self.n_experts)[:, None], self.slot_of.shape
        )
        owner[self.slot_of[live]] = experts[live]
        return owner

    def committed_devices(self) -> set[int]:
        """Devices referenced by any committed replica: the set a token can
        route to this tick."""
        return {int(d) for d in self.slot_of[self._live()] // self.slots_per_device}

    def committed_slots(self, e: int) -> list[int]:
        return [int(s) for s in self.slot_of[e, : self.n_replicas[e]]]

    def slot_on_device(self, e: int, device: int) -> int | None:
        """The committed slot of expert ``e`` on ``device``, if any."""
        for s in self.committed_slots(e):
            if self.device_of(s) == device:
                return s
        return None

    # -- planning view (committed + pending) ---------------------------------

    @property
    def pending(self) -> tuple[tuple[int, int], ...]:
        return tuple(self._pending)

    def used_slots(self, include_pending: bool = True) -> np.ndarray:
        used = np.zeros(self.n_slots, dtype=bool)
        used[self.slot_of[self._live()]] = True
        if include_pending:
            for _, s in self._pending:
                used[s] = True
        return used

    def free_slot(self, device: int, include_pending: bool = True) -> int | None:
        """First free slot on ``device``, or None (reserved slots count as
        used so two in-flight migrations can't collide)."""
        lo = device * self.slots_per_device
        free = ~self.used_slots(include_pending)[lo : lo + self.slots_per_device]
        idx = np.flatnonzero(free)
        return int(lo + idx[0]) if idx.size else None

    def replica_devices(self, e: int, include_pending: bool = True) -> list[int]:
        devs = [self.device_of(s) for s in self.committed_slots(e)]
        if include_pending:
            devs += [self.device_of(s) for ex, s in self._pending if ex == e]
        return devs

    def all_replica_devices(self, include_pending: bool = True) -> list[list[int]]:
        return [
            self.replica_devices(e, include_pending)
            for e in range(self.n_experts)
        ]

    def slots_used(self, include_pending: bool = True) -> np.ndarray:
        """Occupied-slot count per device."""
        return (
            self.used_slots(include_pending)
            .reshape(self.n_devices, self.slots_per_device)
            .sum(axis=1)
        )

    def n_pending(self, e: int) -> int:
        return sum(1 for ex, _ in self._pending if ex == e)

    # -- pending lifecycle: reserve -> (slices land) -> commit ----------------

    def try_reserve(self, e: int, device: int) -> int | None:
        """Reserve a destination slot on ``device`` for a new replica of
        expert ``e``; None when the migration cannot be placed (no free
        slot, device already hosts the expert, or replica-column cap)."""
        if device in self.replica_devices(e):
            return None
        if int(self.n_replicas[e]) + self.n_pending(e) >= self.r_max:
            return None
        slot = self.free_slot(device)
        if slot is None:
            return None
        self._pending.append((e, slot))
        return slot

    def release_pending(self, e: int, slot: int) -> None:
        try:
            self._pending.remove((e, slot))
        except ValueError:
            raise PlacementError(
                f"release of ({e}, {slot}) which is not pending"
            ) from None

    def commit(self, e: int, slot: int) -> None:
        """Atomic swap: publish a fully-copied replica to the routing view.
        Only at a decode-step boundary, after the last weight slice landed."""
        self.release_pending(e, slot)   # raises if never reserved
        r = int(self.n_replicas[e])
        if r >= self.r_max:
            raise PlacementError(
                f"expert {e} at replica cap {self.r_max}; reservation "
                f"accounting is broken"
            )
        self.slot_of[e, r] = slot
        self.n_replicas[e] = r + 1
        self._bump()

    def apply(self, e: int, device: int) -> int | None:
        """Reserve + commit in one step (balancer simulation, evacuation).
        Returns the slot, or None when the replica cannot be placed."""
        slot = self.try_reserve(e, device)
        if slot is not None:
            self.commit(e, slot)
        return slot

    # -- removal -------------------------------------------------------------

    def remove_replica(self, e: int, r: int) -> int:
        """Drop committed replica column ``r`` of expert ``e`` (swap with
        the last); returns the freed slot."""
        n = int(self.n_replicas[e])
        if not (0 <= r < n):
            raise PlacementError(f"expert {e} has no replica column {r}")
        if n == 1:
            raise PlacementError(f"cannot remove expert {e}'s only replica")
        freed = int(self.slot_of[e, r])
        self.slot_of[e, r] = self.slot_of[e, n - 1]
        self.n_replicas[e] = n - 1
        self.slot_of[e, n - 1 :] = self.slot_of[e, 0]
        self._bump()
        return freed

    def drop_device(self, device: int) -> int:
        """Remove every committed replica on ``device`` wherever the expert
        has another (an expert whose only copy sits there keeps it). Tail
        columns are repointed at a live replica, so no entry targets the
        device. One stable argsort partitions each row into kept and
        dropped entries. Returns the number of experts that dropped one."""
        live = self._live()
        on_dead = live & (self.slot_of // self.slots_per_device == device)
        keep = live & ~on_dead
        sole = ~keep.any(axis=1)          # only-copy-was-there experts
        keep[sole] = live[sole]
        order = np.argsort(~keep, axis=1, kind="stable")
        slot_of = np.take_along_axis(self.slot_of, order, axis=1)
        n_rep = keep.sum(axis=1).astype(np.int32)
        tail = np.arange(self.r_max)[None, :] >= n_rep[:, None]
        self.slot_of = np.where(tail, slot_of[:, :1], slot_of).astype(np.int32)
        self.n_replicas = n_rep
        self._bump()
        return int((on_dead.any(axis=1) & ~sole).sum())

    # -- invariants -----------------------------------------------------------

    def check(self) -> None:
        """Internal-consistency assertions (tests call this every tick)."""
        if (self.n_replicas < 1).any() or (self.n_replicas > self.r_max).any():
            raise PlacementError(f"n_replicas out of range: {self.n_replicas}")
        slots = self.slot_of[self._live()]
        if slots.size and (slots.min() < 0 or slots.max() >= self.n_slots):
            raise PlacementError("committed slot out of range")
        flat = [int(s) for s in slots]
        if len(flat) != len(set(flat)):
            raise PlacementError("two replicas share a physical slot")
        committed = set(flat)
        for e, s in self._pending:
            if s in committed:
                raise PlacementError(
                    f"pending slot {s} (expert {e}) is already committed"
                )
