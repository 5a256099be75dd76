"""Model FLOPs of every real prompt and output token the host span
processed over the span's seconds at the dtype's dense peak
(portbench.work)."""

from portbench import work


def read(run):
    ticks = list(run.host_ticks)
    if not ticks:
        return None
    flops = float(run.flops()[ticks].sum())
    return 100.0 * flops / (run.host_seconds() * work.PEAK_FLOPS[run.dtype])
