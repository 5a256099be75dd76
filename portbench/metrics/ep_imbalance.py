"""The EP decode calls' largest device's kept rows over the mean device's,
summed over the traced calls: sum(max_device_rows) / (sum(routed_rows) /
EP devices), 1 when every device takes the same rows (the tracer's
``moe.*`` counters, portbench.program_spans)."""

from portbench import program_spans


def read(run):
    c = program_spans.counters()
    if not c or not c.get("moe.decode_calls") or not c.get("moe.routed_rows"):
        return None
    devices = c["moe.ep_devices"] / c["moe.decode_calls"]
    return c["moe.max_device_rows"] / (c["moe.routed_rows"] / devices)
