"""Share of the traced splice admissions' prefill rows that are padding:
100 x (1 - true prompt tokens / power-of-two bucket tokens) (the tracer's
``admit.*`` counters, portbench.program_spans)."""

from portbench import program_spans


def read(run):
    c = program_spans.counters()
    if not c or not c.get("admit.bucket_tokens"):
        return None
    return 100.0 * (1.0 - c["admit.real_tokens"] / c["admit.bucket_tokens"])
