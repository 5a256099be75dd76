"""What one run measured, as the metric readers see it: every tick's host
times and admissions, every request's submission time
and the tick of each of its tokens, the window, and in a traced run the
two traces (``trace``: host calls, spans and the card; ``device_trace``:
the card alone) and each traced MoE call's rows per expert.

The window is the ticks ``i_open .. i_close - 1``: it opens at the start of
tick ``i_open`` and closes at the end of tick ``i_close - 1``. The host
span is the part of the window that ran without the profiler: all of it,
or in a traced run the ticks after the traced ones.
"""

from __future__ import annotations

import numpy as np

from portbench import work


class Run:
    def __init__(self, *, t0, t1, admits, requests, i_open, i_close,
                 traced_end, model, dtype, batch, setup_s, trace=None, device_trace=None,
                 moe_rows=None):
        self.t0, self.t1 = np.asarray(t0, float), np.asarray(t1, float)
        self.admits = np.asarray(admits)
        self.requests = requests      # [{"submit": s, "ticks": [...], "prompt_len": P}]
        self.i_open, self.i_close = i_open, i_close
        self.host_from = traced_end if traced_end is not None else i_open
        self.model, self.dtype, self.batch, self.setup_s = model, dtype, batch, setup_s
        self.trace, self.device_trace, self.moe_rows = trace, device_trace, moe_rows

    @property
    def t_open(self) -> float:
        return float(self.t0[self.i_open])

    @property
    def t_close(self) -> float:
        return float(self.t1[self.i_close - 1])

    @property
    def host_ticks(self) -> range:
        return range(self.host_from, self.i_close)

    def host_seconds(self) -> float:
        return float(self.t1[self.i_close - 1] - self.t0[self.host_from])

    def in_window(self, tick) -> np.ndarray:
        tick = np.asarray(tick)
        return (tick >= self.i_open) & (tick < self.i_close)

    def decode_rows(self) -> np.ndarray:
        """Rows each tick's decode step served (a request's first token
        comes from its admission prefill, every later one from a decode)."""
        rows = np.zeros(len(self.t1), np.int64)
        for r in self.requests:
            np.add.at(rows, np.asarray(r["ticks"][1:], np.int64), 1)
        return rows

    def flops(self) -> np.ndarray:
        """Model FLOPs of the real tokens each tick processed: each
        admission's prompt, each decoded token at its context."""
        m, out = self.model, np.zeros(len(self.t1))
        for r in self.requests:
            ticks = np.asarray(r["ticks"], np.int64)
            if not len(ticks):
                continue
            p = r["prompt_len"]
            out[ticks[0]] += work.prefill_flops(m, p)
            # a decoded token's FLOPs grow linearly with its context
            base = work.decode_flops(m, 0)
            slope = work.decode_flops(m, 1) - base
            ctx = p + np.arange(1, len(ticks))
            np.add.at(out, ticks[1:], base + slope * ctx)
        return out
