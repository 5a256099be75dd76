"""Share of the device phase's host seconds in which no kernel, copy or
fill ran on the card (the union of the profiler's device intervals; that
phase records the card alone, so the profiler's host cost stays out)."""


def read(run):
    t = run.device_trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
