"""Milliseconds a traced tick the card idled while the innermost program
range open was the scheduler's sampling (``sched.sample``: the logits' read
to the host and the per-slot argmax) or an admission's first-token read
(``sched.admit_read``) (portbench.program_spans)."""

from portbench import program_spans

NAMES = {"repro_torch.sched.sample", "repro_torch.sched.logits_read",
         "repro_torch.sched.argmax", "repro_torch.sched.admit_read"}


def read(run):
    return program_spans.idle_ms_per_tick(run, NAMES.__contains__)
