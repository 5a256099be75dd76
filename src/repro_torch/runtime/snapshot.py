"""Crash-safe serving snapshots: minimal host-side truth, atomic on disk
(PyTorch port of ``repro.runtime.snapshot``; the file is the reference's,
key for key, so a snapshot written by either package restores in the
other).

A :class:`ServerSnapshot` captures what a fresh process needs to resume
serving after a host crash, and nothing more:

* the committed placement table and the balancer's load EMA, dead set and
  straggler slowdowns;
* the pending-migration ledger (plan entries only: partial weight slices
  died with the crashed process and are re-copied from slice zero);
* the scheduler's request book: each request's prompt, emitted prefix and
  scalar lifecycle fields, the queue order, the live slots, the counters,
  the pool-pressure hostage page count.

Not snapshotted: expert weights and KV pages (device state). Weights are
re-placed from the params by the saved table (``Server.restore_snapshot``);
KV is recomputed from the prompt and the emitted prefix on re-admission,
the recompute contract preemption already relies on. A request caught
mid-prefill (chunked admission) restarts from chunk zero: its chunk KV
died with the process. Decoding is greedy, so there is no sampler state.

Scope of "resume": in fp32 (the plain path or the kernels) the streams
before and after the crash concatenate to the uninterrupted run's, bit for
bit. In bf16 a recomputed context's K/V differ in low bits from the K/V
the decode steps wrote (layer 0's K/V projection already rounds otherwise
at a prefill's row count than at decode's; see the scheduler's
determinism contract), so only the streams neither live nor preempted at
the crash are held bit for bit; a stream recomputed after the restore is
logged with the prefix it shares.

Persistence rides :func:`repro_torch.runtime.checkpoint.save`: numeric
leaves in the atomic ``.npz``, the JSON-able structure in the atomic
``.meta`` sidecar, so a crash while snapshotting leaves the previous
snapshot intact.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.runtime import faults as F
from repro_torch.runtime.checkpoint import load_meta, save
from repro_torch.runtime.serve import Server

SNAPSHOT_VERSION = 1


@dataclasses.dataclass
class ServerSnapshot:
    """End-of-tick serving state (see the module docstring for its scope)."""

    step_no: int
    serve_cfg: dict
    sched_cfg: dict
    # server counters
    t: int
    last_mig: int
    migrations: int
    # placement and balancer (None on balancer-less servers)
    table: dict | None
    load_ema: np.ndarray | None
    slowdown: np.ndarray | None
    dead: list[int]
    pending_migrations: list[dict]
    # the scheduler's request book
    next_rid: int
    n_preempted: int
    hostage_pages: int
    requests: list[dict]
    prompts: dict[int, np.ndarray]
    emitted: dict[int, np.ndarray]
    queue_rids: list[int]
    live_rids: list[int | None]


def snapshot_scheduler(sched) -> ServerSnapshot:
    """Capture a scheduler (and its server) at a tick boundary. Not under a
    mesh yet."""
    srv = sched.server
    if srv.mesh is not None:
        raise NotImplementedError(
            "snapshots of a Server under a mesh are not ported yet (ROADMAP "
            "Queue 1 item 5)"
        )
    table = None
    load_ema = slowdown = None
    dead: list[int] = []
    pending: list[dict] = []
    if srv.table is not None:
        table = {
            "slot_of": srv.table.slot_of.copy(),
            "n_replicas": srv.table.n_replicas.copy(),
            "n_slots": srv.table.n_slots,
            "slots_per_device": srv.table.slots_per_device,
        }
        load_ema = np.asarray(srv.state.load_ema).copy()
        slowdown = None if srv.state.slowdown is None else np.asarray(srv.state.slowdown).copy()
        dead = sorted(int(d) for d in srv.state.dead)
        if srv.driver is not None:
            pending = srv.driver.export_in_flight()
    requests = []
    prompts: dict[int, np.ndarray] = {}
    emitted: dict[int, np.ndarray] = {}
    for r in sched.requests:
        requests.append({
            "rid": int(r.rid),
            "max_new_tokens": int(r.max_new_tokens),
            "eos_id": None if r.eos_id is None else int(r.eos_id),
            "arrival": int(r.arrival),
            "state": r.state,
            "preemptions": int(r.preemptions),
            "error": r.error,
            # informational: restore re-prefills from chunk zero regardless
            "prefill_pos": int(r.prefill_pos),
            "admitted_step": r.admitted_step,
            "first_token_step": r.first_token_step,
            "last_token_step": r.last_token_step,
            "max_stall": int(r.max_stall),
        })
        prompts[r.rid] = np.asarray(r.prompt, np.int32).copy()
        emitted[r.rid] = np.asarray(r.tokens_out, np.int32)
    return ServerSnapshot(
        step_no=int(sched.step_no),
        serve_cfg=dataclasses.asdict(srv.scfg),
        sched_cfg=dataclasses.asdict(sched.cfg),
        t=int(srv.t),
        last_mig=int(srv.last_mig),
        migrations=int(srv.migrations),
        table=table,
        load_ema=load_ema,
        slowdown=slowdown,
        dead=dead,
        pending_migrations=pending,
        next_rid=int(sched._rid),
        n_preempted=int(sched.n_preempted),
        hostage_pages=len(sched._hostage),
        requests=requests,
        prompts=prompts,
        emitted=emitted,
        queue_rids=[int(r.rid) for r in sched.queue],
        live_rids=[None if r is None else int(r.rid) for r in sched.slots],
    )


def save_snapshot(path: str, snap: ServerSnapshot) -> None:
    """Persist atomically: arrays in the ``.npz``, structure in ``.meta``."""
    tree: dict[str, np.ndarray] = {}
    if snap.table is not None:
        tree["table/slot_of"] = snap.table["slot_of"]
        tree["table/n_replicas"] = snap.table["n_replicas"]
        tree["balancer/load_ema"] = snap.load_ema
        if snap.slowdown is not None:
            tree["balancer/slowdown"] = snap.slowdown
    for rid, p in snap.prompts.items():
        tree[f"prompt/{rid}"] = p
    for rid, e in snap.emitted.items():
        tree[f"emitted/{rid}"] = e
    meta = {
        "version": SNAPSHOT_VERSION,
        "step_no": snap.step_no,
        "serve_cfg": snap.serve_cfg,
        "sched_cfg": snap.sched_cfg,
        "t": snap.t,
        "last_mig": snap.last_mig,
        "migrations": snap.migrations,
        "table": None if snap.table is None else {
            "n_slots": snap.table["n_slots"],
            "slots_per_device": snap.table["slots_per_device"],
        },
        "dead": snap.dead,
        "pending_migrations": snap.pending_migrations,
        "next_rid": snap.next_rid,
        "n_preempted": snap.n_preempted,
        "hostage_pages": snap.hostage_pages,
        "requests": snap.requests,
        "queue_rids": snap.queue_rids,
        "live_rids": snap.live_rids,
    }
    save(path, tree, step=snap.step_no, extra={"snapshot": meta})


def load_snapshot(path: str) -> ServerSnapshot:
    with np.load(path) as data:
        arrays = dict(data)
    meta = load_meta(path)["snapshot"]
    table = None
    load_ema = slowdown = None
    if meta["table"] is not None:
        table = {
            "slot_of": arrays["table/slot_of"],
            "n_replicas": arrays["table/n_replicas"],
            "n_slots": int(meta["table"]["n_slots"]),
            "slots_per_device": int(meta["table"]["slots_per_device"]),
        }
        load_ema = arrays["balancer/load_ema"]
        slowdown = arrays.get("balancer/slowdown")
    rids = [int(r["rid"]) for r in meta["requests"]]
    return ServerSnapshot(
        step_no=int(meta["step_no"]),
        serve_cfg=dict(meta["serve_cfg"]),
        sched_cfg=dict(meta["sched_cfg"]),
        t=int(meta["t"]),
        last_mig=int(meta["last_mig"]),
        migrations=int(meta["migrations"]),
        table=table,
        load_ema=load_ema,
        slowdown=slowdown,
        dead=[int(d) for d in meta["dead"]],
        pending_migrations=list(meta["pending_migrations"]),
        next_rid=int(meta["next_rid"]),
        n_preempted=int(meta["n_preempted"]),
        hostage_pages=int(meta["hostage_pages"]),
        requests=[dict(r) for r in meta["requests"]],
        prompts={rid: arrays[f"prompt/{rid}"] for rid in rids},
        emitted={rid: arrays[f"emitted/{rid}"] for rid in rids},
        queue_rids=[int(r) for r in meta["queue_rids"]],
        live_rids=[None if r is None else int(r) for r in meta["live_rids"]],
    )


def restore_scheduler(snap: ServerSnapshot | str, cfg, ctx, params, distance=None,
                      faults=None, device="cuda"):
    """Rebuild a live scheduler on a fresh process from a snapshot (or its
    path). ``params`` are the logical params (un-expanded expert rows), as a
    fresh ``Server`` takes them, on ``device``. Requests that were live at
    the crash (DECODING, or PREFILLING with ``prefill_pos`` back to 0) lost
    their KV with the process: they re-enter at the queue front, in slot
    order, as PREEMPTED for the standard recompute, without the crash being
    charged to their preemption budget. ``faults`` (the original plan) loses
    its ``crash_restart`` entries at or before the snapshot's step, so the
    crash does not recur."""
    from repro_torch.runtime.scheduler import (
        PREEMPTED,
        Request,
        RequestScheduler,
        SchedulerConfig,
    )

    if isinstance(snap, str):
        snap = load_snapshot(snap)
    if faults is not None:
        faults = F.FaultPlan([f for f in faults
                              if not (f.kind == F.CRASH_RESTART and f.step <= snap.step_no)])
    srv = Server.restore_snapshot(snap, cfg, ctx, params, distance=distance, device=device)
    sched = RequestScheduler(srv, SchedulerConfig(**snap.sched_cfg), faults=faults)
    by_rid: dict[int, Request] = {}
    for rec in snap.requests:
        rid = int(rec["rid"])
        req = Request(
            rid=rid,
            prompt=np.asarray(snap.prompts[rid], np.int32),
            max_new_tokens=int(rec["max_new_tokens"]),
            eos_id=rec["eos_id"],
            arrival=int(rec["arrival"]),
            state=rec["state"],
            tokens_out=[int(x) for x in snap.emitted[rid]],
            preemptions=int(rec["preemptions"]),
            error=rec["error"],
            # prefill_pos stays 0; the stats fields survive so the TTFT and
            # stall numbers span the crash (.get: older snapshots lack them)
            admitted_step=rec.get("admitted_step"),
            first_token_step=rec.get("first_token_step"),
            last_token_step=rec.get("last_token_step"),
            max_stall=int(rec.get("max_stall", 0)),
        )
        by_rid[rid] = req
        sched.requests.append(req)
    front = [by_rid[rid] for rid in snap.live_rids if rid is not None]
    for req in front:
        req.state = PREEMPTED
        req.slot = None
    for req in front + [by_rid[rid] for rid in snap.queue_rids]:
        sched.queue.append(req)
    sched.step_no = snap.step_no
    sched._rid = snap.next_rid
    sched.n_preempted = snap.n_preempted
    if snap.hostage_pages:
        sched._hostage = srv.page_pool.alloc(min(snap.hostage_pages, srv.page_pool.n_free))
    sched.last_snapshot = snap
    return sched
