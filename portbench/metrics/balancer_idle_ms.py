"""Milliseconds a traced tick the card idled while the innermost program
range open was the NI-Balancer's (``balance.*``: draining migrations and
their slices, reading and observing the step's expert counts, planning):
what the balancer costs the critical path (portbench.program_spans)."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms_per_tick(run, lambda name: name.startswith("repro_torch.balance."))
