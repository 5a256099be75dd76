"""Percentiles as the end-to-end metrics take them: linear interpolation
between the closest ranks of all samples (numpy's default method)."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def ttfts_ms(run) -> list[float]:
    """Submission to the end of the tick that emitted the first token, for
    every request whose first token fell in the window."""
    out = []
    for r in run.requests:
        if r["ticks"] and run.in_window(r["ticks"][0]):
            out.append((run.t1[r["ticks"][0]] - r["submit"]) * 1e3)
    return out


def itls_ms(run) -> list[float]:
    """Every gap between consecutive tokens of a request, both in the
    window."""
    out = []
    for r in run.requests:
        t = r["ticks"]
        for a, b in zip(t, t[1:]):
            if run.in_window(a) and run.in_window(b):
                out.append((run.t1[b] - run.t1[a]) * 1e3)
    return out


def tokens_in_window(run) -> int:
    return sum(int(run.in_window(r["ticks"]).sum()) for r in run.requests if r["ticks"])
