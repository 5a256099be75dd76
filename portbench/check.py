"""How ``correct`` is decided: served greedy tokens against the plain
reference.

Once the window has closed and the program is freed, a sample of the
requests the program finished, drawn from the seed and always holding the
one with the most served tokens, is run through the reference (prompt and
served tokens, teacher-forced). At the position that produced each served
token the reference's best logit and the served token's logit differ by a
gap, in units of that position's reference logits' standard deviation; a
greedy token that the reference also ranks first reads 0. The compared
number is the mean gap over every sampled position (``mean_gap_sd``). The
widest gap (``max_gap_sd``) is reported beside it and not compared: on
these random-weight models bf16 rounding flips a token's routing or an
argmax often enough that sound runs' widest gap reaches as far as the
control's (PERF.md, section 4).

The control (``quant="fp8"``) is the reference in float8: at the same
positions, the token that it ranks first is read by the fp32 reference the
same way.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from portbench import reference as R

HERE = Path(__file__).resolve().parent
SAMPLE_TOKENS = 512       # served tokens the sample reaches, at least
SAMPLE_MIN, SAMPLE_MAX = 4, 12


def load_limit(cell: str, root: Path = HERE) -> dict:
    return json.loads((root / "limits" / f"{cell}.json").read_text())


def sample(done: list[dict], seed: int) -> list[dict]:
    """The longest finished request, then others in an order drawn from
    the seed, until the sample holds SAMPLE_TOKENS served tokens (at least
    SAMPLE_MIN requests, at most SAMPLE_MAX)."""
    if not done:
        return []
    done = sorted(done, key=lambda r: r["rid"])
    longest = max(done, key=lambda r: (len(r["tokens"]), -r["rid"]))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 0xC4EC]).permutation(len(rest))
    out, n = [longest], len(longest["tokens"])
    for i in order:
        if len(out) >= SAMPLE_MAX or (n >= SAMPLE_TOKENS and len(out) >= SAMPLE_MIN):
            break
        out.append(rest[i])
        n += len(rest[i]["tokens"])
    return out


def teacher_forced(reqs: list[dict]) -> tuple[list, list]:
    """Each request's prompt and served tokens but the last, and the
    positions whose logits chose the served tokens."""
    seqs, reads = [], []
    for r in reqs:
        p, t = np.asarray(r["prompt"]), np.asarray(r["tokens"])
        seqs.append(np.concatenate([p, t[:-1]]).astype(np.int64))
        reads.append(np.arange(len(p) - 1, len(p) - 1 + len(t)))
    return seqs, reads


def gaps_sd(ref_rows: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """(best - chosen) / std of each reference row."""
    best = ref_rows.max(dim=-1).values
    got = ref_rows.gather(1, chosen.long()[:, None])[:, 0]
    return (best - got) / ref_rows.std(dim=-1, unbiased=False)


def readings(m: dict, seed: int, dtype, device, reqs: list[dict],
             control: bool = False, std: float = 0.02) -> dict:
    """``max_gap_sd`` of the served tokens and, with ``control``, of the
    fp8 control's first choices, over the sampled requests."""
    if not reqs:
        return {"mean_gap_sd": float("inf"), "max_gap_sd": float("inf"), "positions": 0,
                "requests": 0}
    seqs, reads = teacher_forced(reqs)
    with R.exact_fp32():
        ref = R.logits_at(m, seed, dtype, device, seqs, reads, std=std)
        low = (R.logits_at(m, seed, dtype, device, seqs, reads, quant="fp8", std=std)
               if control else None)
    served = [torch.as_tensor(np.asarray(r["tokens"]), device=device) for r in reqs]
    out = {**summary(torch.cat([gaps_sd(a, t) for a, t in zip(ref, served)])),
           "positions": int(sum(len(r) for r in reads)), "requests": len(reqs)}
    if control:
        low_gaps = torch.cat([gaps_sd(a, c.argmax(dim=-1)) for a, c in zip(ref, low)])
        out.update({f"control_{k}": v for k, v in summary(low_gaps).items()})
    return out


def summary(g: torch.Tensor) -> dict:
    """The widest gap, the mean gap and the share of positions whose
    token the reference does not rank first."""
    return {"max_gap_sd": float(g.max()), "mean_gap_sd": float(g.mean()),
            "mismatch_share": float((g > 0).float().mean())}
