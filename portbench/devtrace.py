"""The device trace of a traced slice: ``torch.profiler`` on the host and
the card, exported through kineto's chrome trace and reduced here.

* device activity: kernels, copies and fills on the card, each with the
  correlation id of the host call that launched it;
* spans: the ``record_function`` ranges the harness opens (``portbench.*``)
  on the host thread;
* a kernel belongs to a span when the host call that launched it ran
  inside the span.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"


class Trace:
    """One profiled phase. Its window is the ``portbench.window`` span, or,
    in a phase that recorded the card alone, ``window_s`` host seconds
    holding all of the phase's device activity."""

    def __init__(self, events: list[dict], window_s: float | None = None):
        self.device = []          # (start_us, end_us, name, correlation)
        self.launch = {}          # correlation -> host start_us
        self.spans = defaultdict(list)   # name -> [(start_us, end_us)]
        host = defaultdict(list)  # tid -> [(start_us, end_us, name)]
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e.get("ts", 0)), float(e.get("dur", 0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", "?"), corr))
            elif cat in HOST_CATS:
                if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                    self.launch[corr] = ts
                if cat == "user_annotation" and e.get("name", "").startswith("portbench."):
                    self.spans[e["name"]].append((ts, ts + dur))
                host[e.get("tid")].append((ts, ts + dur, e.get("name", "?")))
        if WINDOW in self.spans:
            self.w0, self.w1 = self.spans[WINDOW][0]
        elif window_s is not None:
            self.w0 = min((a for a, _, _, _ in self.device), default=0.0)
            self.w1 = self.w0 + window_s * 1e6
            self.w1 = max([self.w1] + [b for _, b, _, _ in self.device])
        else:
            self.w0 = self.w1 = 0.0
        self._window_s = window_s
        # the thread that opened the window is the one that drives the card
        self.host = []
        for ops in host.values():
            if any(n == WINDOW for _, _, n in ops):
                self.host = sorted(ops, key=lambda o: (o[0], -o[1]))

    @property
    def window_s(self) -> float:
        if self._window_s is not None:
            return self._window_s
        return (self.w1 - self.w0) / 1e6

    def busy(self) -> list[tuple[float, float]]:
        """The union of device activity inside the window, merged."""
        iv = sorted((max(a, self.w0), min(b, self.w1)) for a, b, _, _ in self.device)
        out = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def span_device_s(self, name: str) -> float:
        """Seconds of device activity launched from inside span ``name``."""
        spans = sorted(self.spans.get(name, []))
        if not spans:
            return 0.0
        starts = [a for a, _ in spans]
        total = 0.0
        for a, b, _, corr in self.device:
            t = self.launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += b - a
        return total / 1e6

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for a, b, name, _ in self.device:
            by[name[:160]] += (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle seconds of the card inside the window, summed by what the
        driving thread was doing: the innermost harness span open at the
        middle of each gap, and the innermost host call open when the gap
        began (a call that waits for the card, or Python between calls)."""
        busy = self.busy()
        gaps, t = [], self.w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            gaps.append((t, self.w1))
        spans = self._open_at([(a + b) / 2 for a, b in gaps], harness_only=True)
        calls = self._open_at([a for a, _ in gaps], harness_only=False)
        by = defaultdict(float)
        for (a, b), span, call in zip(gaps, spans, calls):
            by[f"{span}: {call}"] += (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def _open_at(self, times: list[float], harness_only: bool) -> list[str]:
        """The innermost host call (or harness span) open at each of the
        sorted ``times``."""
        ops = [o for o in self.host if not harness_only or o[2].startswith("portbench.")]
        out, stack, i = [], [], 0
        for t in times:
            while i < len(ops) and ops[i][0] <= t:
                a, b, name = ops[i]
                while stack and stack[-1][0] <= a:
                    stack.pop()
                stack.append((b, name))
                i += 1
            while stack and stack[-1][0] <= t:
                stack.pop()
            out.append(stack[-1][1][:120] if stack else "none")
        return out


def profiler(cuda: bool, host: bool):
    """A profiler of the card's activity (``cuda``) and the host's calls
    (``host``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CPU] if host else []) + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def read(prof, window_s: float | None = None) -> Trace:
    """Export ``prof``'s trace to a file in the temporary directory, read
    it back and delete it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return Trace(events, window_s)
