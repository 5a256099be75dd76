"""The plain reference of the served models: fp32 PyTorch, TF32 off, no
kernels, no cache, no batching. It imports nothing of the program."""

from portbench.reference.model import logits_at, exact_fp32

__all__ = ["logits_at", "exact_fp32"]
