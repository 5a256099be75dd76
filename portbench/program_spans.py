"""The program's own ranges and counters as the per-layer metrics read
them (``repro_torch.runtime.tracing``).

Ranges: the ``repro_torch.*`` host ranges of the driving thread in the
spans phase's trace. Each idle gap of the card in that phase is put down to
the innermost program range open at the gap's middle, and a metric sums the
gaps of its ranges over the phase's ticks (its ``portbench.tick`` spans).
Counters: the tracer's set, read once after the window; it covers the last
profiled stretch that recorded the host. A program without the tracer has
neither, and every reader then returns None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = "repro_torch."
TICK = "portbench.tick"
NONE = ""


def _gaps(trace) -> list[tuple[float, float]]:
    gaps, t = [], trace.w0
    for a, b in trace.busy():
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if trace.w1 > t:
        gaps.append((t, trace.w1))
    return gaps


def _innermost(ops: list, times: list[float]) -> list[str]:
    """The innermost of ``ops`` (start, end, name), sorted by start and
    then longest first, open at each of the sorted ``times``."""
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
        out.append(stack[-1][1] if stack else NONE)
    return out


def _inside(spans: list[tuple[float, float]], t: float) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint ``spans``."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and t <= spans[i][1]


def idle_by_range(trace, within: str | None = None) -> dict[str, float] | None:
    """Idle seconds of the card by the innermost program range open at
    each gap's middle (``NONE``: no program range open). With ``within``,
    a harness span, only the gaps whose middle lies in one of its spans
    count, where the trace has any. None without device activity or
    without a program range in the trace."""
    if trace is None or not trace.device:
        return None
    ops = [o for o in trace.host if o[2].startswith(PREFIX)]
    if not ops:
        return None
    gaps = _gaps(trace)
    inside = sorted(trace.spans.get(within, [])) if within else []
    if inside:
        gaps = [(a, b) for a, b in gaps if _inside(inside, (a + b) / 2)]
    by = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(ops, [(a + b) / 2 for a, b in gaps])):
        by[name] += (b - a) / 1e6
    return dict(by)


def idle_ms_per_tick(run, pick, within: str | None = None) -> float | None:
    """Milliseconds a traced tick the card idled under the program ranges
    whose name ``pick`` accepts (``within``: as in ``idle_by_range``)."""
    by = idle_by_range(run.trace, within)
    ticks = len(run.trace.spans.get(TICK, [])) if run.trace is not None else 0
    if by is None or not ticks:
        return None
    return 1e3 * sum(s for name, s in by.items() if name != NONE and pick(name)) / ticks


def counters() -> dict | None:
    """The tracer's counters, or None without the tracer or a count."""
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    return tracing.counters() or None
