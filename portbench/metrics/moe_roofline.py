"""The MoE layer's least time over the device time of every kernel,
copy and fill launched inside its calls, over the traced ticks. The least
time of a call is the larger of its bytes and its FLOPs over the card's
peaks (portbench.work.moe_call): the work, not what a kernel reads."""

from portbench import work


def read(run):
    if run.trace is None or not run.moe_rows:
        return None
    device_s = run.trace.span_device_s("portbench.moe")
    if device_s <= 0:
        return None
    least = sum(work.least_seconds(*work.moe_call(run.model, rows, run.dtype), run.dtype)
                for rows in run.moe_rows)
    return 100.0 * least / device_s
