"""Milliseconds a traced tick the card idled while the innermost program
range open was the MoE layer's (``model.moe`` or a ``moe.*`` phase of it):
the host's work between the layer's launches (portbench.program_spans).

Only the gaps inside the harness's ``portbench.moe`` spans count, where the
trace has them: that span holds the program's MoE call alone, while
``model.moe`` also holds what the harness does around the call in a traced
run (an admission's own routing and bincount)."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms_per_tick(
        run, lambda name: name == "repro_torch.model.moe" or name.startswith("repro_torch.moe."),
        within="portbench.moe")
