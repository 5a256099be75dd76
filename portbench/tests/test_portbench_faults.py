"""The comparison that decides ``correct`` sees the faults a served cell
can have, planted under a smoke-size run on the CPU (the harness's look
for a chip skipped): a token altered, a step that keeps its state, half
the batch left out, routed copies dropped; and the fp8 control comes out not correct where sound runs
are correct. One card has no exchange between chips, so that
fault has no place here."""

import pytest
import torch

import portbench_smoke as S
from repro_torch.models import transformer as T
from repro_torch.runtime.scheduler import RequestScheduler


@pytest.mark.parametrize("workload", ["dbrx-ep.chat", "mixtral-esp.chat"])
def test_token_altered_where_produced(workload, monkeypatch):
    push = RequestScheduler._push_token

    def altered(self, req, tok):
        # every token of every third request, from its second on
        if req.rid % 3 == 0 and req.tokens_out:
            tok = (tok + 1) % self.server.cfg.vocab_size
        return push(self, req, tok)

    monkeypatch.setattr(RequestScheduler, "_push_token", altered)
    res = S.run(workload, 11)
    assert res["correct"] is False
    assert res["check"]["mean_gap_sd"]["value"] > S.SMOKE_LIMIT


def test_step_returns_its_state_unchanged(monkeypatch):
    step = T.decode_step

    def unchanged(params, token, cache, *a, **kw):
        layers = cache["layers"]
        saved = {k: layers[k].clone() for k in ("pool_k", "pool_v")}
        out = step(params, token, cache, *a, **kw)
        for k, v in saved.items():
            layers[k].copy_(v)
        return out

    monkeypatch.setattr(T, "decode_step", unchanged)
    res = S.run("dbrx-ep.chat", 12)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", ["dbrx-ep.chat", "mixtral-esp.chat"])
def test_half_the_batch_left_out(workload, monkeypatch):
    moe = T.moe_apply

    def half(p, x, *a, **kw):
        y, aux = moe(p, x, *a, **kw)
        keep = torch.ones_like(y)
        keep[x.shape[0] // 2:] = 0
        if x.shape[0] == 1:         # a prefill: its later half of the rows
            keep[:, x.shape[1] // 2:] = 0
        return y * keep, aux

    monkeypatch.setattr(T, "moe_apply", half)
    res = S.run(workload, 13)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", ["dbrx-ep.chat", "mixtral-esp.chat"])
def test_capacity_that_drops_routed_copies(workload):
    # an eighth of the drop-free factor: a prefill's buckets overflow
    cf = S.shrunk(workload)[1]["parallel"]["capacity_factor"] / 8
    res = S.run(workload, 14, parallel={"capacity_factor": cf})
    assert res["correct"] is False
    assert res["check"]["dropped_rows"]["value"] > 0


@pytest.mark.parametrize("workload", ["dbrx-ep.chat", "mixtral-esp.chat"])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_control_comes_out_not_correct(workload, seed):
    res = S.run(workload, seed, control=True)
    assert res["correct"] is True
    control = res["readings"]["control_mean_gap_sd"]
    assert control > S.SMOKE_LIMIT
