"""The system under test, as a cell runs it: the port's ``Server(paged=
True)`` built from a configuration file, driven tick by tick through its
``RequestScheduler`` by closed-loop clients.

Each of ``clients`` callers submits its next request as soon as its last
one finished (``arrival`` = the scheduler's next tick). A token is stamped
with the host clock at the end of the ``step()`` that pushed it; ``step()``
reads the logits to the host every tick, so that end is synchronised.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime.scheduler import FAILED, RequestScheduler
from repro_torch.runtime.serve import ServeConfig, Server

from portbench import devtrace
from portbench import weights as W
from portbench.reference.model import route

ADMIT = "admit"


def build(config: dict, mix: dict, seed: int, device) -> RequestScheduler:
    """The cell's server, its weights made from ``seed`` on ``device``."""
    m = config["model"]
    params = W.model(m, seed, getattr(torch, config["dtype"]), device, config["init_std"])
    srv = Server(ModelConfig(**m), ParallelCtx(**config["parallel"]), params,
                 ServeConfig(**config["serve"], max_seq=mix["max_seq"]), device=device)
    del params
    return RequestScheduler(srv)


class Probe:
    """What the harness records inside the program's calls: the routed
    copies that every MoE dispatch dropped (every run), and, while tracing,
    spans and each MoE call's rows per expert.

    Drops are read from the program's own dispatch: each call of
    ``dispatch_metadata`` (ESP's, and through ``bucket_dispatch`` EP's)
    returns the capacity-survival mask of its copies, and a copy bound for
    a real bucket that the mask does not keep was dropped. The count stays
    on the device until the window has closed."""

    def __init__(self, sched: RequestScheduler, config: dict):
        self.srv = sched.server
        self.k = config["model"]["experts_per_token"]
        self.dropped = torch.zeros((), dtype=torch.long, device=self.srv.device)
        self.dispatches = 0
        self.tracing = False
        self.moe_rows: list[torch.Tensor] = []
        self.true_len: int | None = None
        self._saved = None

    def __enter__(self):
        srv = self.srv
        self._saved = (T.moe_apply, srv.prefill_into_slot, srv.decode,
                       C.dispatch_metadata, M.dispatch_metadata)
        moe_apply, prefill_into_slot, decode, meta = self._saved[:4]

        def counted(bucket_ids, n_buckets, capacity):
            out = meta(bucket_ids, n_buckets, capacity)
            self.dispatches += 1
            self.dropped += (bucket_ids < n_buckets).sum() - out[-1].sum()
            return out

        def moe(p, x, cfg, ctx, placement=None, token_mask=None):
            if not self.tracing:
                return moe_apply(p, x, cfg, ctx, placement=placement, token_mask=token_mask)
            if x.shape[1] > 1:     # an admission prefill: its real rows only
                ids, _ = route(x[0, : self.true_len], p["router"], self.k)
                self.moe_rows.append(torch.bincount(ids.reshape(-1), minlength=cfg.n_experts))
            with record_function("portbench.moe"):
                y, aux = moe_apply(p, x, cfg, ctx, placement=placement, token_mask=token_mask)
            if x.shape[1] == 1:    # decode: the program's counts skip empty slots
                self.moe_rows.append(aux["counts"])
            return y, aux

        def admit(slot, tokens, cache, length=None):
            self.true_len = length
            if not self.tracing:
                return prefill_into_slot(slot, tokens, cache, length=length)
            with record_function("portbench.admit"):
                return prefill_into_slot(slot, tokens, cache, length=length)

        def step(token, cache, chunk=None):
            if not self.tracing:
                return decode(token, cache, chunk=chunk)
            with record_function("portbench.decode"):
                return decode(token, cache, chunk=chunk)

        T.moe_apply, srv.prefill_into_slot, srv.decode = moe, admit, step
        C.dispatch_metadata = M.dispatch_metadata = counted
        return self

    def __exit__(self, *exc):
        T.moe_apply, C.dispatch_metadata, M.dispatch_metadata = (
            self._saved[0], self._saved[3], self._saved[4])
        del self.srv.prefill_into_slot, self.srv.decode
        return False


class Loop:
    """Closed-loop clients over the scheduler, and the record of every
    tick and every request."""

    def __init__(self, sched: RequestScheduler, stream, clients: int, sync):
        self.sched, self.stream, self.sync = sched, stream, sync
        self.clock = time.perf_counter
        self.t0, self.t1, self.admits, self.migrations = [], [], [], []
        self.requests: list[dict] = []
        self.live: dict[int, dict] = {}
        self.finished_by_client = [0] * clients
        self.finished = 0
        self.tracing = False
        now = self.clock()
        for c in range(clients):
            self._submit(c, now)

    def _submit(self, client: int, now: float) -> None:
        prompt, n_new = self.stream.next()
        req = self.sched.submit(prompt, n_new, arrival=self.sched.step_no)
        rec = {"rid": req.rid, "client": client, "prompt": prompt, "submit": now,
               "ticks": [], "req": req, "done": None}
        self.requests.append(rec)
        if req.state == FAILED:
            rec["done"] = len(self.t1)
            return
        self.live[req.rid] = rec

    def tick(self) -> None:
        sched = self.sched
        n_ev, i = len(sched.events), len(self.t1)
        t0 = self.clock()
        if self.tracing:
            with record_function("portbench.tick"):
                sched.step()
        else:
            sched.step()
        t1 = self.clock()
        self.t0.append(t0)
        self.t1.append(t1)
        self.admits.append(sum(1 for _, kind, _ in sched.events[n_ev:] if kind == ADMIT))
        self.migrations.append(sched.server.migrations)
        for rec in list(self.live.values()):
            req = rec["req"]
            n = len(req.tokens_out) - len(rec["ticks"])
            if n:
                rec["ticks"].extend([i] * n)
            if req.done:
                rec["done"] = i
                del self.live[rec["rid"]]
                self.finished_by_client[rec["client"]] += 1
                self.finished += 1
                self._submit(rec["client"], t1)

    def warm(self) -> None:
        """Serve until every client has finished one request."""
        while min(self.finished_by_client) < 1:
            self.tick()
        self.sync()

    def window(self, seconds: float, probe: Probe | None = None, trace_ticks: int = 0,
               min_finished: int = 0):
        """Serve for ``seconds`` of host clock from the next tick on, and
        on until ``min_finished`` requests have finished inside the window
        (the comparison's sample; a cell finishes hundreds). With
        ``trace_ticks`` the window's first ticks run under the profiler in
        two phases of that many ticks each: the host's calls and the
        card's activity with the harness's spans, then the card's activity
        alone (the profiler's host cost stays out of the card's idle
        time). Each phase's trace is read as soon as it stops. Returns
        (first tick, end tick, the spans phase's trace, the device phase's
        trace, end of the traced ticks); the traces are None without
        ``trace_ticks``."""
        i_open, finished_before = len(self.t1), self.finished
        cuda = self.sched.server.device.type == "cuda"
        spans = device = traced = None
        if trace_ticks:
            prof = devtrace.profiler(cuda, host=True)
            prof.start()
            with record_function(devtrace.WINDOW):
                probe.tracing = self.tracing = True
                for _ in range(trace_ticks):
                    self.tick()
                self.sync()
                probe.tracing = self.tracing = False
            prof.stop()
            spans = devtrace.read(prof)
            prof = devtrace.profiler(cuda, host=not cuda)
            prof.start()
            t_a = self.clock()
            for _ in range(trace_ticks):
                self.tick()
            self.sync()
            device_s = self.clock() - t_a
            prof.stop()
            device = devtrace.read(prof, device_s)
            traced = len(self.t1)
        while (len(self.t1) == i_open or self.t1[-1] - self.t0[i_open] < seconds
               or self.finished - finished_before < min_finished):
            self.tick()
        self.sync()
        return i_open, len(self.t1), spans, device, traced


def served(loop: Loop, i_open: int) -> list[dict]:
    """Requests that finished inside the window, with their tokens."""
    out = []
    for rec in loop.requests:
        if rec["done"] is not None and rec["done"] >= i_open and rec["ticks"]:
            req = rec["req"]
            out.append({"rid": rec["rid"], "prompt": np.asarray(req.prompt),
                        "tokens": list(req.tokens_out), "failed": req.state == FAILED})
    return out
