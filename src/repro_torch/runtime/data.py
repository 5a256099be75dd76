"""Synthetic data (copies of ``repro.runtime.data``): the training stream
``SyntheticLM`` and the serving-side ``request_stream``.

``SyntheticLM`` is an order-1 Markov chain over the vocab (each token has
4 likely successors, taken 80% of the time), so a short training shows a
falling loss. ``batch_at(step)`` is a pure function of ``(seed, step,
host_id)``, drawn with numpy exactly as the reference draws it, so a
restart replays the same stream from the step cursor a checkpoint keeps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Order-1 Markov stream with a skewed transition structure. Batches
    are int32 tensors on ``device`` (the CPU by default; the trainer
    passes its own)."""

    def __init__(self, cfg: DataConfig, device="cpu"):
        self.cfg = cfg
        self.device = device
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._succ = rng.integers(0, v, size=(v, 4)).astype(np.int64)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 64 + cfg.host_id)
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((b, s + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, v, size=b)
        follow = rng.random((b, s)) < 0.8
        choice = rng.integers(0, 4, size=(b, s))
        rand_tok = rng.integers(0, v, size=(b, s))
        for t in range(s):
            nxt = self._succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand_tok[:, t])
        toks = torch.from_numpy(toks.astype(np.int32))
        return {"tokens": toks[:, :-1].contiguous().to(self.device),
                "labels": toks[:, 1:].contiguous().to(self.device)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def request_stream(vocab_size: int, batch: int, prompt_len: int, seed: int = 0):
    """Prompts of equal length as int32 numpy arrays, one batch per step;
    batch ``i`` draws from ``default_rng(seed + i)`` exactly as the
    reference does."""
    step = 0
    while True:
        rng = np.random.default_rng(seed + step)
        yield rng.integers(0, vocab_size, size=(batch, prompt_len)).astype(np.int32)
        step += 1
