"""Continuous-batching request scheduler over the paged ``Server`` (PyTorch
port of ``repro.runtime.scheduler``).

The ``RequestScheduler`` owns the request lifecycle

    QUEUED -> PREFILLING -> DECODING -> FINISHED
                   ^            |
                   '-- PREEMPTED (requeued, recomputed on re-admission)
                            |
                         FAILED (capacity / retry exhaustion)

over a fixed batch shape: empty slots are masked inert (write-off pages,
length pinned to 0, excluded from MoE routing), so admission, retirement
and preemption are host-side bookkeeping between steps.

Per tick (``step()``):

1. **faults** — drain the :class:`~repro_torch.runtime.faults.FaultPlan`
   for this step (device death and revival, stragglers, pool pressure, NaN
   logits);
2. **admission** — strict FIFO over arrived requests, watermark-gated
   against ``PagePool`` occupancy. With ``ServeConfig(prefill_chunk=C)``
   admission stakes out a slot and its pages; the request then rides the
   decode step's prefill lane, one C-token chunk a tick (one request in
   flight at a time), until the last chunk's logits emit its first token
   and the slot flips to DECODING, so live slots never stall. Without it,
   each admission is a batch-1 prefill of the prompt right-padded to a
   power-of-two bucket, spliced into one empty slot
   (``Server.prefill_into_slot``);
3. **headroom** — if the live requests' next writes need more fresh pages
   than the pool holds, preempt (victim: fewest decoded tokens, youngest
   first) until the step cannot exhaust the pool;
4. **decode** — one step over the whole batch; per-slot argmax on the
   host, EOS / max-token retirement recycling pages and slots mid-flight.

Over a ``Server`` under a mesh every rank runs its own scheduler on the
same requests and plan: the decisions are host-side and depend only on
what every rank sees alike (the plan's draws, the pool, the global
logits the Server gathers), so every rank admits, preempts and fires the
same events, and its Server does its part of each step.

Crash safety: ``snapshot_every`` ticks, and when a ``crash_restart`` fault
fires, the scheduler snapshots the end of the previous tick
(:mod:`repro_torch.runtime.snapshot`); a crash then raises
:class:`~repro_torch.runtime.faults.SimulatedCrash`, and
``snapshot.restore_scheduler`` rebuilds a scheduler that serves on. Under
a mesh the fault fires on every rank at the same tick, every rank checks
that it holds the same snapshot, rank 0 writes the file, and every rank
restores from it.

Determinism contract: per-request outputs are a pure function of (params,
prompt, max_new_tokens, eos), independent of batch composition, arrival
order, placement changes, preemptions, the admission mode and crashes,
because every per-token computation is row-independent, expert replicas
are exact weight copies, chunked admission computes the same prefill a
chunk at a time, and preempted or crashed work is recomputed from the
prompt plus the emitted tokens. The caveat is capacity
drops: keep ``ParallelCtx.capacity_factor`` high enough that no routed copy
is dropped.

Its scope: bit-identical streams hold in fp32, on the plain path and with
the kernels alike. In bf16 they hold for a stream that is never recomputed
from its context, and only for it: a context's K/V written one token a
step by decode differ in low bits from the K/V a prefill writes for the
same context. On the card the first difference is layer 0's K/V
projection, a plain cuBLAS product run at M = 8 batch rows in decode and
at M = context rows in a prefill (one bf16 ulp; ``chip_smoke.py`` phase
3e's probe). So a stream recomputed from its context (after a preemption
or a crash) and a chunk-admitted stream held against a splice-admitted
one may leave the stream they are compared with; they are logged with the
prefix they share, not held.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.runtime import faults as F
from repro_torch.runtime import tracing as TR

QUEUED = "QUEUED"
PREFILLING = "PREFILLING"
DECODING = "DECODING"
FINISHED = "FINISHED"
PREEMPTED = "PREEMPTED"
FAILED = "FAILED"


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle state."""

    rid: int
    prompt: np.ndarray               # (P,) int32 prompt tokens
    max_new_tokens: int
    eos_id: int | None = None
    arrival: int = 0                 # earliest scheduler step for admission
    state: str = QUEUED
    slot: int | None = None          # batch row while PREFILLING/DECODING
    tokens_out: list = dataclasses.field(default_factory=list)
    preemptions: int = 0             # pool evictions + fault requeues
    error: str | None = None
    # Chunked admission: context tokens the prefill lane has written. Only
    # meaningful while PREFILLING; back to 0 on preemption or crash (the KV
    # dies with the slot or the process and re-admission starts over).
    prefill_pos: int = 0
    # Serving stats (ticks are scheduler steps, not wall time).
    admitted_step: int | None = None     # first PREFILLING/DECODING tick
    first_token_step: int | None = None  # tick the first token was emitted
    last_token_step: int | None = None   # tick of the most recent token
    max_stall: int = 0                   # widest gap between tokens, -1 tick

    @property
    def ttft_ticks(self) -> int | None:
        """Ticks from arrival until the first token existed (1 = the first
        eligible tick emitted it). None until it has."""
        if self.first_token_step is None:
            return None
        return self.first_token_step - self.arrival + 1

    @property
    def n_decoded(self) -> int:
        return len(self.tokens_out)

    @property
    def context_len(self) -> int:
        """Tokens a (re)admission prefill must write: the prompt plus every
        token already emitted (recompute-on-preemption)."""
        return len(self.prompt) + len(self.tokens_out)

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, FAILED)


@dataclasses.dataclass
class SchedulerConfig:
    # Admit only while (occupied + needed) / pool <= watermark. A request
    # that can't pass it with the system otherwise empty is admitted anyway.
    admit_watermark: float = 0.85
    # A request evicted more than this many times FAILs.
    max_preemptions: int = 8
    # Prompts are right-padded to power-of-two buckets (>= this floor).
    prompt_bucket_floor: int = 8
    # run() safety valve.
    max_steps: int = 10_000
    # Crash safety: every `snapshot_every` ticks, snapshot the end of the
    # previous tick (kept on `last_snapshot`, also written atomically to
    # `snapshot_path` when set). 0 disables the cadence; a crash_restart
    # fault snapshots at its tick regardless.
    snapshot_every: int = 0
    snapshot_path: str = ""


class RequestScheduler:
    """Host-side continuous-batching loop over a paged ``Server``."""

    def __init__(self, server, cfg: SchedulerConfig | None = None, faults=None):
        if not server.scfg.paged:
            raise ValueError(
                "RequestScheduler needs ServeConfig(paged=True): slot-level "
                "admission and retirement are page-table operations"
            )
        self.cfg = cfg or SchedulerConfig()
        self.faults = faults or F.FaultPlan()
        self.server = server
        self.batch = server.scfg.batch
        self.cap_tokens = server.n_blocks * server.page_size
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Request | None] = [None] * self.batch
        self.cache = server.empty_cache()
        self.next_tok = np.zeros((self.batch, 1), np.int32)
        self.step_no = 0
        self.requests: list[Request] = []
        self.events: list[tuple] = []        # (step, kind, detail)
        self.n_preempted = 0
        self._rid = 0
        self._hostage: list[int] = []        # pages stolen by pool_pressure
        self._poison: set[int] | None = None  # nan_logits slots this tick
        self.last_snapshot = None            # most recent ServerSnapshot
        # Chunked admission: at most one request mid-prefill, the head of
        # admission, one chunk a tick through the decode step's prefill lane.
        self.chunk: int | None = server.scfg.prefill_chunk
        self._prefilling: Request | None = None

    # -- submission ----------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        eos_id: int | None = None,
        arrival: int = 0,
    ) -> Request:
        """Enqueue a request. Requests whose full context can never fit the
        per-request KV capacity FAIL at once."""
        req = Request(
            rid=self._rid,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens),
            eos_id=eos_id,
            arrival=int(arrival),
        )
        self._rid += 1
        self.requests.append(req)
        if req.max_new_tokens < 1 or len(req.prompt) < 1:
            req.state = FAILED
            req.error = "empty prompt or non-positive max_new_tokens"
            return req
        if len(req.prompt) + req.max_new_tokens - 1 > self.cap_tokens:
            req.state = FAILED
            req.error = (
                f"request needs {len(req.prompt) + req.max_new_tokens - 1} KV "
                f"rows > per-request capacity {self.cap_tokens}; raise "
                f"max_seq or trim the request"
            )
            return req
        self.queue.append(req)
        return req

    # -- pool accounting -----------------------------------------------------

    def _pages_for(self, n_tokens: int) -> int:
        ps = self.server.page_size
        nb = self.server.n_blocks
        return min(-(-min(n_tokens, self.cap_tokens) // ps), nb)

    def _live(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _admissible(self, req: Request) -> bool:
        pool = self.server.page_pool
        need = self._pages_for(req.context_len)
        if need > pool.n_free:
            return False
        if not self._live():
            return True   # empty system: progress beats the watermark
        occupied = pool.n_pages - pool.n_free
        return occupied + need <= self.cfg.admit_watermark * pool.n_pages

    # -- lifecycle transitions ----------------------------------------------

    def _bucket(self, n: int) -> int:
        m = self.cfg.prompt_bucket_floor
        while m < n:
            m *= 2
        return min(m, self.cap_tokens)

    def _admit(self, req: Request, slot: int) -> None:
        req.state = PREFILLING
        req.admitted_step = self.step_no
        if self.chunk:
            # Chunked admission: no device work here, only the slot and the
            # pages; step() feeds the prefill lane one chunk a tick.
            req.slot = slot
            req.prefill_pos = 0
            self.slots[slot] = req
            self._prefilling = req
            self.server.begin_chunk_prefill(slot, req.context_len)
            self.events.append((self.step_no, "admit", req.rid))
            return
        ctx_tokens = np.concatenate(
            [req.prompt, np.asarray(req.tokens_out, np.int32)]
        )
        true_len = len(ctx_tokens)
        padded = np.zeros(self._bucket(true_len), np.int32)
        padded[:true_len] = ctx_tokens
        TR.count(TR.ADMIT_REAL_TOKENS, true_len)
        TR.count(TR.ADMIT_BUCKET_TOKENS, len(padded))
        logits, self.cache = self.server.prefill_into_slot(
            slot, padded[None, :], self.cache, length=true_len
        )
        req.slot = slot
        self.slots[slot] = req
        req.state = DECODING
        self.events.append((self.step_no, "admit", req.rid))
        # The prefill's last-position logits emit this request's next token:
        # for a recompute, bit for bit the token the preempted decode would
        # have produced next. fp32 on the device first (numpy has no bf16;
        # exact for an argmax), the argmax on the host so ties break as the
        # reference's do.
        with TR.span(TR.SCHED_ADMIT_READ):
            tok = int(np.argmax(logits[0, -1].float().cpu().numpy()))
        self._push_token(req, tok)

    def _push_token(self, req: Request, tok: int) -> bool:
        """Append an emitted token; retire on EOS / max-token. Returns
        whether the request finished."""
        req.tokens_out.append(tok)
        if req.first_token_step is None:
            req.first_token_step = self.step_no
        elif req.last_token_step is not None:
            req.max_stall = max(
                req.max_stall, self.step_no - req.last_token_step - 1
            )
        req.last_token_step = self.step_no
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if hit_eos or len(req.tokens_out) >= req.max_new_tokens:
            self._retire(req, FINISHED)
            return True
        self.next_tok[req.slot, 0] = tok
        return False

    def _retire(self, req: Request, state: str) -> None:
        """Free the request's slot and pages (reusable by the very next
        admission, mid-flight)."""
        self.cache = self.server.release(req.slot, self.cache)
        self.slots[req.slot] = None
        req.slot = None
        req.state = state
        self.events.append((self.step_no, "retire", req.rid))

    def _preempt(self, req: Request, reason: str) -> None:
        """Evict a running request; requeue it at the front for recompute,
        or FAIL it past the retry budget. Only this request is affected. A
        request preempted mid-prefill emitted no token: its side pages go
        back to the pool and re-admission starts from position 0."""
        if req.state == PREFILLING and self.chunk:
            self.server.abort_chunk_prefill(req.slot)
            if self._prefilling is req:
                self._prefilling = None
            req.prefill_pos = 0
        else:
            self.cache = self.server.release(req.slot, self.cache)
        self.slots[req.slot] = None
        req.slot = None
        req.preemptions += 1
        self.n_preempted += 1
        self.events.append((self.step_no, "preempt", (req.rid, reason)))
        if req.preemptions > self.cfg.max_preemptions:
            req.state = FAILED
            req.error = f"evicted {req.preemptions} times (last: {reason})"
        else:
            req.state = PREEMPTED
            self.queue.appendleft(req)

    # -- per-tick phases -----------------------------------------------------

    def _apply_faults(self) -> None:
        pool = self.server.page_pool
        for f in self.faults.at(self.step_no):
            self.events.append((self.step_no, "fault", (f.kind, f)))
            if f.kind == F.CRASH_RESTART:
                continue   # handled at the top of step(), before the snapshot
            if f.kind == F.DEVICE_DEATH:
                plan = self.server.mark_dead(f.device)
                self.events.append(
                    (self.step_no, "evacuated", (f.device, len(plan)))
                )
            elif f.kind == F.DEVICE_REVIVAL:
                plan = self.server.revive(f.device)
                self.events.append(
                    (self.step_no, "revived", (f.device, len(plan)))
                )
            elif f.kind == F.STRAGGLER:
                self.server.report_step_time(f.device, f.ratio)
            elif f.kind == F.POOL_PRESSURE:
                stolen = pool.alloc(min(f.pages, pool.n_free))
                self._hostage.extend(stolen)
            elif f.kind == F.POOL_RELEASE:
                n = min(f.pages or len(self._hostage), len(self._hostage))
                back, self._hostage = self._hostage[:n], self._hostage[n:]
                pool.free(back)
            elif f.kind == F.NAN_LOGITS:
                self._poison = set(f.slots) if f.slots else None
                if self._poison is None:
                    self._poison = {i for i, r in enumerate(self.slots) if r}

    def _admit_ready(self) -> None:
        while self.queue:
            if self.chunk and self._prefilling is not None:
                # one admission in flight: the lane takes one chunk a tick,
                # and strict FIFO lets nobody overtake the head anyway
                return
            free = self._free_slots()
            if not free:
                return
            # Strict FIFO among arrived requests: the earliest-queued
            # arrived request either admits or blocks admission this tick.
            head = next(
                (r for r in self.queue if r.arrival <= self.step_no), None
            )
            if head is None or not self._admissible(head):
                return
            self.queue.remove(head)
            with TR.span(TR.SCHED_ADMIT):
                self._admit(head, free[0])

    def _ensure_headroom(self) -> None:
        """Preempt until this step's lazy page growth cannot exhaust the
        pool (victim: fewest decoded tokens; ties broken youngest-first)."""
        srv = self.server
        while True:
            live = self._live()
            deficit = (
                sum(srv.next_write_unbacked(r.slot) for r in live if r.state == DECODING)
                - srv.page_pool.n_free
            )
            if deficit <= 0 or not live:
                return
            # A request mid-prefill holds every page it will need, so it adds
            # nothing to the deficit, but it is the cheapest victim (no
            # decoded token) and frees the most pages at once.
            victim = min(live, key=lambda r: (r.n_decoded, -r.rid))
            self._preempt(victim, "pool-exhausted")

    def _drain_migrations(self) -> None:
        """Keep in-flight stepped migrations landing on idle ticks: with
        requests live the decode step drives the MigrationDriver; an idle
        tick has no decode to ride, so the scheduler advances the slices."""
        if not self._live():
            self.server.drain_migrations()

    # -- the tick ------------------------------------------------------------

    def save_snapshot(self, path: str | None = None):
        """Capture the end of the previous tick as a ``ServerSnapshot``
        (kept on ``last_snapshot``); with ``path``, also write it through the
        atomic checkpoint writer. Under a mesh every rank captures it (the
        ranks' snapshots checked equal) and rank 0 writes the one file."""
        from repro_torch.runtime import snapshot as S

        snap = S.snapshot_scheduler(self)
        if path:
            S.save_snapshot(path, snap, self.server.mesh)
        self.last_snapshot = snap
        return snap

    def _chunk_operand(self):
        """This tick's prefill-lane operand for the request mid-prefill
        (right-padded to the chunk size) and its valid token count."""
        pf = self._prefilling
        ctx_tokens = np.concatenate([pf.prompt, np.asarray(pf.tokens_out, np.int32)])
        n = min(self.chunk, len(ctx_tokens) - pf.prefill_pos)
        buf = np.zeros(self.chunk, np.int32)
        buf[:n] = ctx_tokens[pf.prefill_pos : pf.prefill_pos + n]
        return self.server.chunk_operand(pf.slot, buf, pf.prefill_pos, n), n

    def step(self) -> list[Request]:
        """One scheduler tick. Returns the requests that finished.

        Snapshots and crashes come first, before faults, admission or
        decode, so a snapshot always captures a tick boundary (the end of
        the previous tick) and the crash tick's faults fire once after a
        restore."""
        if (self.cfg.snapshot_every and self.step_no
                and self.step_no % self.cfg.snapshot_every == 0):
            self.save_snapshot(self.cfg.snapshot_path or None)
        crash = next((f for f in self.faults.at(self.step_no)
                      if f.kind == F.CRASH_RESTART), None)
        if crash is not None:
            snap = self.save_snapshot(crash.path or None)
            raise F.SimulatedCrash(self.step_no, snap, crash.path)
        with TR.span(TR.SCHED_FAULTS):
            self._apply_faults()
        self._admit_ready()
        with TR.span(TR.SCHED_HEADROOM):
            self._ensure_headroom()
        with TR.span(TR.SCHED_DRAIN):
            self._drain_migrations()
        finished: list[Request] = []
        if self._live():
            pf = self._prefilling
            with TR.span(TR.SCHED_DECODE):
                chunk, chunk_n = self._chunk_operand() if pf is not None else (None, 0)
                logits, self.cache = self.server.decode(self.next_tok, self.cache,
                                                        chunk=chunk)
            with TR.span(TR.SCHED_SAMPLE):
                # (B, V) on the host in fp32 (numpy has no bf16; exact for the
                # argmax), poisoned there as the reference does.
                with TR.span(TR.SCHED_LOGITS_READ):
                    rows = logits[:, -1].float().cpu().numpy()
                with TR.span(TR.SCHED_ARGMAX):
                    poison = self._poison or set()
                    if poison:
                        rows = rows.copy()   # on the CPU, .numpy() shares the logits
                        rows[sorted(poison)] = np.nan
                    for slot, req in enumerate(self.slots):
                        if req is None or req.state != DECODING:
                            continue    # a PREFILLING row is masked garbage
                        row = rows[slot]
                        if not np.isfinite(row).all():
                            # Numerics blew up for this row only: requeue it
                            # for a clean recompute instead of emitting garbage.
                            self._preempt(req, "non-finite-logits")
                            continue
                        if self._push_token(req, int(np.argmax(row))):
                            finished.append(req)
            if pf is not None:
                pf.prefill_pos += chunk_n
                if pf.prefill_pos >= pf.context_len:
                    # The last chunk: its last valid position's logits emit
                    # the first token, and the slot flips live.
                    with TR.span(TR.SCHED_ADMIT_READ):
                        crow = self.server.last_chunk_logits[0, -1].float().cpu().numpy()
                    if pf.slot in poison or not np.isfinite(crow).all():
                        self._preempt(pf, "non-finite-logits")
                    else:
                        self.cache = self.server.finish_chunk_prefill(
                            pf.slot, self.cache, pf.context_len)
                        pf.state = DECODING
                        self._prefilling = None
                        if self._push_token(pf, int(np.argmax(crow))):
                            finished.append(pf)
        self._poison = None
        self.step_no += 1
        return finished

    def run(self, max_steps: int | None = None) -> dict[int, np.ndarray]:
        """Drive ``step()`` until every submitted request is FINISHED or
        FAILED (idle ticks advance time toward future arrivals / faults).
        Returns ``results()``."""
        limit = max_steps or self.cfg.max_steps
        last_fault = max((f.step for f in self.faults), default=-1)
        for _ in range(limit):
            if all(r.done for r in self.requests) and not self.queue:
                return self.results()
            self.step()
            if (
                not self._live()
                and self.queue
                and self.step_no > last_fault
                and all(r.arrival <= self.step_no for r in self.queue)
                and not any(self._admissible(r) for r in self.queue)
            ):
                # Nothing live, nothing can ever admit (pool starved for
                # good): fail the head instead of spinning forever.
                stuck = self.queue.popleft()
                stuck.state = FAILED
                stuck.error = (
                    f"needs {self._pages_for(stuck.context_len)} pages; "
                    f"pool has {self.server.page_pool.n_free} free for "
                    f"good: undersized pool or leaked pressure"
                )
                self.events.append((self.step_no, "admit-failed", stuck.rid))
        if not all(r.done for r in self.requests):
            raise RuntimeError(
                f"scheduler made no full progress in {limit} steps: "
                f"{[r.state for r in self.requests]}"
            )
        return self.results()

    def results(self) -> dict[int, np.ndarray]:
        """rid -> emitted tokens (every submitted request; FAILED requests
        report what they produced before failing)."""
        return {
            r.rid: np.asarray(r.tokens_out, np.int32) for r in self.requests
        }

    def stats(self) -> dict:
        """Serving statistics in scheduler ticks (not wall time).
        ``prefill_backlog`` counts the context tokens still to prefill (the
        rest of the request mid-prefill and every queued request's
        context); ``max_stall_ticks`` is the widest gap between a request's
        consecutive tokens minus one."""
        backlog = sum(r.context_len for r in self.queue)
        if self._prefilling is not None:
            backlog += self._prefilling.context_len - self._prefilling.prefill_pos
        ttfts = [
            r.ttft_ticks for r in self.requests if r.ttft_ticks is not None
        ]
        return {
            "step": self.step_no,
            "queue_depth": len(self.queue),
            "prefill_backlog": backlog,
            "n_preempted": self.n_preempted,
            "ep_chunks": self.server.scfg.ep_chunks,
            "max_ttft_ticks": max(ttfts, default=None),
            "max_stall_ticks": max(
                (r.max_stall for r in self.requests), default=0
            ),
            "per_request": {
                r.rid: {
                    "state": r.state,
                    "ttft_ticks": r.ttft_ticks,
                    "max_stall_ticks": r.max_stall,
                    "n_tokens": r.n_decoded,
                    "preemptions": r.preemptions,
                }
                for r in self.requests
            },
        }
