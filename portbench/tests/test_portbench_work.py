"""The work counts behind mfu and moe_roofline, against layer FLOPs and
bytes worked by hand for both configurations."""

import json
from pathlib import Path

from portbench import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


def test_dbrx_layer_by_hand():
    m = model("dbrx-132b-ep")
    # q and o: 6144 x 6144 each; k and v: 6144 x 1024 each
    attn = 2 * 6144 * 6144 + 2 * 6144 * 1024
    experts = 4 * 3 * 6144 * 10752
    assert work.layer_params(m) == attn + 6144 * 16 + experts
    # a token at context 100: 4 layers x (2 x params + 4 x 48 x 128 x 100)
    assert work.token_flops(m, 100) == 4 * (2 * (attn + 6144 * 16 + experts) + 4 * 48 * 128 * 100)
    assert work.logits_flops(m) == 2 * 6144 * 100352


def test_mixtral_layer_by_hand():
    m = model("mixtral-8x22b-esp")
    attn = 2 * 6144 * 6144 + 2 * 6144 * 1024
    experts = 2 * 3 * 6144 * 16384
    assert work.layer_params(m) == attn + 6144 * 8 + experts
    assert work.decode_flops(m, 1) == 8 * (2 * work.layer_params(m) + 4 * 48 * 128) \
        + 2 * 6144 * 32768


def test_prefill_sums_contexts():
    m = model("dbrx-132b-ep")
    p = 37
    by_token = sum(work.token_flops(m, c) for c in range(1, p + 1))
    assert abs(work.prefill_flops(m, p) - (by_token + work.logits_flops(m))) < 1e-6 * by_token


def test_moe_call_counts_the_work():
    m = model("dbrx-132b-ep")
    rows = [64] * 4 + [0] * 12
    nbytes, flops = work.moe_call(m, rows, "bfloat16")
    # 4 experts hit: 3 bf16 weights of 6144 x 10752 each; 256 rows in and out
    assert nbytes == 4 * 3 * 6144 * 10752 * 2 + 256 * 2 * 6144 * 2
    assert flops == 256 * 2 * 3 * 6144 * 10752
    # decode-sized: bytes bound; the layer's 16 experts read once, 6.34 GB
    nb, fl = work.moe_call(m, [16] * 16, "bfloat16")
    assert nb == 16 * 3 * 6144 * 10752 * 2 + 256 * 2 * 6144 * 2
    assert work.least_seconds(nb, fl, "bfloat16") == nb / work.PEAK_BYTES_PER_S
    # prefill-sized: FLOPs bound
    nb, fl = work.moe_call(m, [4096] * 16, "bfloat16")
    assert work.least_seconds(nb, fl, "bfloat16") == fl / work.PEAK_FLOPS["bfloat16"]
