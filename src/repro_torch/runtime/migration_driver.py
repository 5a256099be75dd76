"""Live stepped expert migration, driven through the decode loop (PyTorch
port of ``repro.runtime.migration_driver``).

Lifecycle of one migration ``(expert, src_device, dst_device)``:

1. **submit** — reserve a destination slot in the shared
   :class:`~repro_torch.parallel.placement.PlacementTable` (pending:
   visible to the balancer's planning view, invisible to routing) and
   decompose the move into Local/Global hops; the hop count floors the
   slice count.
2. **tick** (one per decode step) — copy one slice of rows ``[lo, lo+rows)``
   of every expert weight from the source slot into the reserved slot, as
   an in-place ``copy_`` on the live parameter tensors, queued on the
   current stream before the step's kernels. Only those rows move: never
   the whole weight (tens of GB at full width). Under a mesh, where the
   two slots live on different ranks of a model group, the source's owner
   sends the slice and the destination's owner receives it into place;
   every rank issues a tick's slices in the same order, so the pairs
   match.
3. **commit** — at the first tick after the final slice was issued, the
   table commit publishes the replica to the routing view. Stream order
   guarantees the copy landed before any kernel that reads the new routing
   view; that single host-side table swap is the atomic commit point.

Device death mid-migration (``Server.mark_dead``) never publishes a torn
replica: in-flight migrations *to* the dead device abort (the reservation
is released) and requeue toward a live destination from slice zero;
migrations *from* it fast-forward (the remaining slices are issued at once
and committed), which is safe under the logical death model (routing stops
but the device's memory stays addressable; see ``Server.mark_dead``).
Under a mesh both go through the same cross-rank ``copy_row_slice`` as a
tick's slices, issued in the same order on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core.er_mapping import Mapping, baseline_mapping
from repro_torch.core.migration import Migration, MigStep, decompose
from repro_torch.core.topology import MeshTopology
from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.placement import PlacementTable
from repro_torch.runtime import tracing as TR

MOE_WEIGHTS = ("w_gate", "w_up", "w_down")


def copy_row_slice(w: torch.Tensor, src_slot: int, dst_slot: int, lo: int,
                    rows: int, mesh: Mesh | None = None) -> None:
    """Copy rows ``[lo, lo+rows)`` of slot ``src_slot`` onto ``dst_slot`` of
    ``w`` ``(L, n_slots, rows_total, cols)``, in place. Under a mesh ``w``
    holds this rank's ``n_slots / n_model`` slot rows: the copy is local
    when one rank owns both slots, else a send from the source's owner to
    the destination's owner in this rank's model group; other ranks do
    nothing."""
    if mesh is None:
        w[:, dst_slot, lo : lo + rows].copy_(w[:, src_slot, lo : lo + rows])
        return
    local = w.shape[1]
    src_owner, dst_owner = src_slot // local, dst_slot // local
    me = mesh.model_rank
    src = w[:, src_slot % local, lo : lo + rows]
    dst = w[:, dst_slot % local, lo : lo + rows]
    if src_owner == dst_owner:
        if me == src_owner:
            dst.copy_(src)
    elif me == src_owner:
        dist.send(src.contiguous(), mesh.global_rank(mesh.data_rank, dst_owner))
    elif me == dst_owner:
        buf = torch.empty_like(dst)
        dist.recv(buf, mesh.global_rank(mesh.data_rank, src_owner))
        dst.copy_(buf)


@dataclasses.dataclass
class InFlightMigration:
    mig: Migration
    src_slot: int
    dst_slot: int
    n_slices: int
    hops: list[MigStep]
    submitted: int                 # server tick at submission
    next_slice: int = 0
    issue_ticks: list[int] = dataclasses.field(default_factory=list)

    @property
    def expert(self) -> int:
        return self.mig[0]

    @property
    def copied(self) -> bool:
        return self.next_slice >= self.n_slices

    def record(self, committed: int | None) -> dict:
        return {
            "mig": tuple(self.mig),
            "expert": self.expert,
            "src_slot": self.src_slot,
            "dst_slot": self.dst_slot,
            "n_slices": self.n_slices,
            "hops": [(h.kind, h.src, h.dst) for h in self.hops],
            "submitted": self.submitted,
            "issue_ticks": list(self.issue_ticks),
            "committed": committed,
        }


class MigrationDriver:
    """Owns the in-flight migrations; the Server ticks it once per decode
    step (and the scheduler on idle ticks, via ``drain_migrations``)."""

    def __init__(self, table: PlacementTable, min_slices: int = 4,
                 mapping: Mapping | None = None, mesh: Mesh | None = None):
        self.table = table
        self.mesh = mesh
        self.min_slices = max(1, int(min_slices))
        # Virtual EP has no physical mesh: a 1-D mesh where every device
        # shares one FTD (decompose then yields one Local hop).
        self.mapping = mapping or baseline_mapping(
            MeshTopology(1, table.n_devices), table.n_devices, 1
        )
        self.expert_bytes: float | None = None
        self.in_flight: list[InFlightMigration] = []
        self.history: list[dict] = []
        self.aborted: list[dict] = []

    def _slot_bytes(self, moe: dict) -> float:
        if self.expert_bytes is None:
            self.expert_bytes = float(
                sum(
                    moe[w].element_size() * moe[w].numel() / moe[w].shape[1]
                    for w in MOE_WEIGHTS
                )
            )
        return self.expert_bytes

    def submit(self, plan: list[Migration], moe: dict, t: int) -> list[Migration]:
        """Reserve destination slots for a balancer plan and build each
        migration's slice schedule; unplaceable entries are skipped.
        Returns the accepted migrations."""
        accepted: list[Migration] = []
        nbytes = self._slot_bytes(moe)
        for mig in plan:
            e, src, dst = mig
            src_slot = self.table.slot_on_device(e, src)
            if src_slot is None:
                continue
            dst_slot = self.table.try_reserve(e, dst)
            if dst_slot is None:
                continue
            hops = decompose(mig, self.mapping, nbytes)
            self.in_flight.append(
                InFlightMigration(
                    mig=mig, src_slot=src_slot, dst_slot=dst_slot,
                    n_slices=max(self.min_slices, len(hops)), hops=hops,
                    submitted=t,
                )
            )
            accepted.append(mig)
        return accepted

    def _issue_slice(self, moe: dict, fl: InFlightMigration, t: int) -> None:
        i = fl.next_slice
        with TR.span(TR.BALANCE_SLICE):
            for name in MOE_WEIGHTS:
                w = moe[name]
                total = w.shape[2]
                chunk = min(total, -(-total // fl.n_slices))
                lo = max(0, min(i * chunk, total - chunk))
                copy_row_slice(w, fl.src_slot, fl.dst_slot, lo, chunk, self.mesh)
        fl.next_slice += 1
        fl.issue_ticks.append(t)

    def tick(self, moe: dict, t: int) -> list[dict]:
        """Commit migrations whose last slice was issued on a previous tick
        (the atomic table swap, at the step boundary), then issue this
        tick's slice for the rest. Returns the committed records."""
        committed: list[dict] = []
        remaining: list[InFlightMigration] = []
        for fl in self.in_flight:
            if fl.copied:
                self.table.commit(fl.expert, fl.dst_slot)
                rec = fl.record(committed=t)
                self.history.append(rec)
                committed.append(rec)
            else:
                self._issue_slice(moe, fl, t)
                remaining.append(fl)
        self.in_flight = remaining
        return committed

    def handle_device_death(
        self,
        device: int,
        moe: dict,
        t: int,
        retarget: Callable[[Migration], Migration | None] | None = None,
    ) -> dict:
        """Resolve in-flight migrations touching a dead device before
        evacuation plans against the table. Migrations **to** it abort (the
        reservation is released; routing never saw the slot) and requeue as
        ``retarget(mig)`` from slice zero; migrations **from** it
        fast-forward (remaining slices issued now, then committed)."""
        survivors: list[InFlightMigration] = []
        out = {"aborted": [], "requeued": [], "fast_forwarded": []}
        requeue: list[Migration] = []
        for fl in self.in_flight:
            e = fl.expert
            if self.table.device_of(fl.dst_slot) == device:
                self.table.release_pending(e, fl.dst_slot)
                rec = fl.record(committed=None)
                self.aborted.append(rec)
                out["aborted"].append(rec)
                new_mig = retarget(fl.mig) if retarget else None
                if new_mig is not None:
                    requeue.append(new_mig)
            elif self.table.device_of(fl.src_slot) == device:
                while not fl.copied:
                    self._issue_slice(moe, fl, t)
                self.table.commit(e, fl.dst_slot)
                rec = fl.record(committed=t)
                self.history.append(rec)
                out["fast_forwarded"].append(rec)
            else:
                survivors.append(fl)
        self.in_flight = survivors
        if requeue:
            out["requeued"] = self.submit(requeue, moe, t)
        return out

    @property
    def pending(self) -> int:
        return len(self.in_flight)

    def export_in_flight(self) -> list[dict]:
        """JSON-able ledger of in-flight migrations, for crash snapshots: the
        plan entry and its progress only (a restore re-submits from slice
        zero against the restored table)."""
        return [
            {
                "mig": list(fl.mig),
                "next_slice": fl.next_slice,
                "n_slices": fl.n_slices,
                "submitted": fl.submitted,
            }
            for fl in self.in_flight
        ]
