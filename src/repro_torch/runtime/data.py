"""Serving-side synthetic request batches (copy of
``repro.runtime.data.request_stream``)."""

from __future__ import annotations

import numpy as np


def request_stream(vocab_size: int, batch: int, prompt_len: int, seed: int = 0):
    """Prompts of equal length as int32 numpy arrays, one batch per step;
    batch ``i`` draws from ``default_rng(seed + i)`` exactly as the
    reference does."""
    step = 0
    while True:
        rng = np.random.default_rng(seed + step)
        yield rng.integers(0, vocab_size, size=(batch, prompt_len)).astype(np.int32)
        step += 1
