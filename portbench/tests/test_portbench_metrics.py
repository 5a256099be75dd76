"""The end-to-end and per-layer arithmetic on synthetic ticks: a rate over
the whole window, tails over every request and every gap, and a stall in
the middle of the window that moves every end-to-end metric."""

import pytest

from portbench import record, spec, stats

MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             vocab_size=256, n_experts=4, experts_per_token=2, moe_d_ff=96)


def synthetic(n_ticks=400, stall=None, clients=8, out=20, tick_s=0.02):
    """Closed-loop clients, one token a tick each; a request's first token
    comes the tick after its submission. ``stall = (a, b, factor)``
    stretches ticks a .. b - 1."""
    t0, t1, t = [], [], 0.0
    for i in range(n_ticks):
        d = tick_s * (stall[2] if stall and stall[0] <= i < stall[1] else 1)
        t0.append(t)
        t += d
        t1.append(t)
    reqs, next_free = [], [0] * clients
    for c in range(clients):
        start = c % 5          # staggered clients
        while start + out < n_ticks:
            submit = t1[start - 1] if start else 0.0
            reqs.append({"submit": submit, "ticks": list(range(start, start + out)),
                         "prompt_len": 10})
            start += out
        next_free[c] = start
    return record.Run(t0=t0, t1=t1, admits=[1 if i % 4 == 0 else 0 for i in range(n_ticks)],
                      requests=reqs,
                      i_open=100, i_close=n_ticks, traced_end=None, model=MODEL,
                      dtype="bfloat16", batch=clients, setup_s=1.5)


def e2e(run):
    return {m["name"]: spec.reader(m["name"])(run)
            for m in spec.load()["end_to_end"]}


def test_rate_is_over_the_whole_window():
    run = synthetic()
    tokens = stats.tokens_in_window(run)
    assert tokens == sum(1 for r in run.requests for k in r["ticks"] if 100 <= k < 400)
    assert e2e(run)["output_tok_s"] == pytest.approx(tokens / (300 * 0.02))


def test_tails_are_over_every_sample():
    run = synthetic()
    ttfts = stats.ttfts_ms(run)
    firsts = [r for r in run.requests if 100 <= r["ticks"][0] < 400]
    assert len(ttfts) == len(firsts)
    gaps = stats.itls_ms(run)
    assert len(gaps) == sum(sum(1 for a, b in zip(r["ticks"], r["ticks"][1:])
                                if a >= 100 and b < 400) for r in run.requests)
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95)


def test_a_stall_moves_every_end_to_end_metric():
    base, stalled = e2e(synthetic()), e2e(synthetic(stall=(200, 320, 3)))
    assert stalled["output_tok_s"] < base["output_tok_s"]
    for name in ("ttft_p50_ms", "ttft_p95_ms", "itl_p95_ms"):
        assert stalled[name] > base[name], name
    assert stalled["setup_s"] == base["setup_s"]


def test_per_layer_readers():
    run = synthetic()
    rows = run.decode_rows()
    # every request decodes out - 1 tokens after its prefill token
    assert rows.sum() == sum(len(r["ticks"]) - 1 for r in run.requests)
    read = {n: spec.reader(n)(run) for n in ("batch_fill", "admit_tick_ms",
                                             "decode_tick_ms", "mfu")}
    assert 0 < read["batch_fill"] <= 100
    assert read["admit_tick_ms"] == pytest.approx(20) and read["decode_tick_ms"] == pytest.approx(20)
    assert 0 < read["mfu"] < 1e-3
    # no trace: the device readers find nothing and return nothing
    assert spec.reader("moe_roofline")(run) is None
    assert spec.reader("device_idle")(run) is None
