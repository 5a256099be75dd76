"""The one traffic generator: a closed-loop request stream from a mix's
parameters (``traffic/<name>.json``).

Lengths come from a fixed set of quantiles of each stated distribution,
so every seed serves the same mix: the stream is a sequence of blocks, and
each block pairs the ``block`` prompt-length quantiles with the ``block``
output-length quantiles, each set in an order the seed draws. Token ids are
Zipf-distributed over the model's vocabulary; the map from rank to id is a
permutation fixed by the mix's ``zipf.permutation_seed``. So the seed
changes only the order of the lengths, their pairing and the tokens.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str, root: Path = HERE) -> dict:
    path = root / "traffic" / f"{name}.json"
    return json.loads(path.read_text())


def quantile_lengths(spec: dict, n: int) -> list[int]:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``spec``'s
    distribution (``loguniform`` or ``uniform`` over [lo, hi])."""
    lo, hi = spec["lo"], spec["hi"]
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "loguniform":
        vals = [math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo))) for q in qs]
    elif spec["dist"] == "uniform":
        vals = [lo + q * (hi - lo) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(hi, max(lo, round(v))) for v in vals]


class Stream:
    """Requests ``(prompt int32 array, max_new_tokens)`` in submission
    order, the same for the same (mix, vocabulary, seed)."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.block = int(mix["block"])
        self.prompts = quantile_lengths(mix["prompt_tokens"], self.block)
        self.outputs = quantile_lengths(mix["output_tokens"], self.block)
        z = mix["zipf"]
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        cdf = np.cumsum(ranks ** -float(z["exponent"]))
        self.cdf = cdf / cdf[-1]
        self.ids = np.random.default_rng(int(z["permutation_seed"])).permutation(vocab)
        self.rng = np.random.default_rng([int(seed), 0x7AFF1C])
        self.pending: list[tuple[int, int]] = []

    def _refill(self) -> None:
        po = self.rng.permutation(self.block)
        oo = self.rng.permutation(self.block)
        self.pending = [(self.prompts[p], self.outputs[o]) for p, o in zip(po, oo)][::-1]

    def tokens(self, n: int) -> np.ndarray:
        ranks = np.searchsorted(self.cdf, self.rng.random(n), side="right")
        return self.ids[np.minimum(ranks, len(self.ids) - 1)].astype(np.int32)

    def next(self) -> tuple[np.ndarray, int]:
        if not self.pending:
            self._refill()
        p, o = self.pending.pop()
        return self.tokens(p), o
