"""The dense (non-paged) decode cache of the port against the JAX package:
the flash-decode plain version against the Pallas kernel in interpret
mode, dense ``decode_attention`` (the full-attention overflow freeze and
the sliding-window ring), prefill's cache fill and decode steps of the
whole model, and the Server's dense-cache guards. fp32 on the CPU, within
1e-5. The CUDA kernel runs on the card (``tests/test_torch_cuda.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.kernels.flash_decode.flash_decode import flash_decode as pallas_decode
from repro.kernels.flash_decode.ref import decode_ref
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.parallel.ctx import ParallelCtx as JCtx
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke
from repro_torch.kernels import registry
from repro_torch.kernels.flash_decode.flash_decode import flash_decode
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime.serve import ServeConfig, Server

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("t", [40, 128])
def test_flash_decode_plain_matches_jax_and_pallas(t):
    """Masks that are a prefix, a ring's wrapped set and a scatter; the
    port's inputs carry NaN in every invalid K/V row (the JAX oracle and
    the Pallas kernel get the clean cache: the oracle's masked PV product
    is not NaN-safe). No T % 128 gate: 40 works as well."""
    rng = np.random.default_rng(t)
    b, h, kv, hd = 3, 8, 2, 16
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    valid = np.zeros((b, t), np.int32)
    valid[0, :17] = 1                               # prefix
    valid[1, t - 5 :] = valid[1, :9] = 1            # wrapped ring
    valid[2] = rng.random(t) < 0.5                  # scattered
    args = [jnp.asarray(a) for a in (q, k, v, valid)]
    want = np.asarray(decode_ref(*args))
    kern = np.asarray(pallas_decode(*args, interpret=True))
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[valid == 0] = np.nan
    v_bad[valid == 0] = np.nan
    got = flash_decode(_t(q), _t(k_bad), _t(v_bad), _t(valid)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, kern, **TOL)
    via_registry = registry.decode_attend(_t(q), _t(k), _t(v), _t(valid.astype(bool)))
    np.testing.assert_allclose(via_registry.numpy(), want, **TOL)
    assert registry.can_flash_decode(t, h, kv, 32, torch.float32)   # any T


def test_flash_decode_row_without_valid_keys_is_zero():
    q = torch.randn(2, 4, 32)
    k = torch.randn(2, 6, 2, 32)
    valid = torch.tensor([[0] * 6, [1] * 6], dtype=torch.int32)
    out = flash_decode(q, k, k.clone(), valid)
    assert (out[0] == 0).all() and bool(out[1].abs().sum() > 0)
    assert not registry.can_flash_decode(64, 48, 8, 100, torch.float32)
    assert registry.can_flash_decode(1024, 48, 8, 128, torch.bfloat16)


@pytest.mark.parametrize("window,s,steps", [(0, 5, 6), (8, 5, 9), (8, 12, 5)],
                         ids=["full-overflow", "ring-wraps", "ring-prefill-rolled"])
def test_dense_decode_attention_matches_reference(window, s, steps):
    """Prefill fill then decode steps against the reference's
    ``decode_attention``: a full-attention cache of 8 slots decoded past
    its end (the freeze), and a window-8 ring wrapped during decode or
    already at prefill (the roll). Both kernel routes of the port agree."""
    jcfg = dataclasses.replace(jsmoke(jget("dbrx-132b")), sliding_window=window)
    cfg = dataclasses.replace(smoke(get_config("dbrx-132b")), sliding_window=window)
    jp = JA.attn_init(jax.random.PRNGKey(3), jcfg)
    p = {n: _t(v) for n, v in jp.items()}
    max_seq = 8 if window == 0 else 64
    rng = np.random.default_rng(4)
    xs = (rng.standard_normal((2, s + steps, cfg.d_model)) * 0.5).astype(np.float32)
    jcache = JA.cache_init(jcfg, 2, max_seq)
    _, (jk, jv) = JA.attention(jp, jnp.asarray(xs[:, :s]), jcfg, JCtx(), return_kv=True)
    length = jcache["k"].shape[1]
    kk, vv = jk[:, -length:], jv[:, -length:]
    if window and s >= length:
        kk, vv = jnp.roll(kk, s % length, axis=1), jnp.roll(vv, s % length, axis=1)
    jcache = {"k": jcache["k"].at[:, : kk.shape[1]].set(kk),
              "v": jcache["v"].at[:, : vv.shape[1]].set(vv)}
    cache = A.cache_init(cfg, 2, max_seq)
    _, (k, v) = A.attention(p, _t(xs[:, :s]), cfg, ParallelCtx(), return_kv=True)
    A.dense_prefill_fill(cache, k, v, cfg)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
    for i in range(steps):
        pos = s + i
        x = xs[:, pos : pos + 1]
        jout, jcache = JA.decode_attention(jp, jnp.asarray(x), jcache, jnp.int32(pos),
                                           jcfg, JCtx())
        before = cache["k"].clone()
        out, cache = A.decode_attention(p, _t(x), cache, pos, cfg, ParallelCtx())
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
        np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]), **TOL)
        if not window and pos >= length:
            assert torch.equal(cache["k"], before)        # frozen at capacity
        # the kernel route (its plain version on the CPU) gives the same
        q = torch.randn(2, 1, cfg.n_heads, cfg.head_dim_)
        j = torch.arange(length)
        mask = (pos - torch.remainder(pos - j, length) >= 0) if window else \
            j <= min(pos, length - 1)
        np.testing.assert_allclose(
            A._flash_decode(q, cache["k"], cache["v"], mask).numpy(),
            A.gqa_attend(q, cache["k"], cache["v"], mask[None, None, None, None, :]).numpy(),
            **TOL)


@pytest.mark.parametrize("arch,s,steps", [("dbrx-132b", 7, 4), ("mixtral-8x22b", 36, 4)])
def test_dense_prefill_and_decode_steps_match_reference(arch, s, steps):
    """The whole model on the dense cache (ESP MoE): prefill logits and
    cache, then decode steps' logits and expert counts. Mixtral's smoke
    window (32) is already wrapped at prefill (36 tokens)."""
    jcfg, cfg = jsmoke(jget(arch)), smoke(get_config(arch))
    jparams = JT.init_params(jax.random.PRNGKey(5), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    jctx, ctx = JCtx(moe_impl="esp"), ParallelCtx(moe_impl="esp")
    jlog, jcache = JT.prefill(jparams, jnp.asarray(tokens), jcfg, jctx, max_seq=48)
    log, cache = T.prefill(params, torch.tensor(tokens), cfg, ctx, max_seq=48)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][name].numpy(),
                                   np.asarray(jcache["layers"][name]), **TOL)
    tok = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
    for _ in range(steps):
        jlog, jcache, jst = JT.decode_step(jparams, jnp.asarray(tok), jcache, jcfg, jctx)
        log, cache, st = T.decode_step(params, torch.tensor(tok), cache, cfg, ctx)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_array_equal(st["expert_counts"].numpy(),
                                      np.asarray(jst["expert_counts"]))
        tok = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
    assert cache["pos"] == s + steps == int(jcache["pos"])


def test_server_dense_cache_guards():
    """Full attention refuses a decode step past max_seq; the page-pool
    calls need a paged cache; virtual EP serves through ep only."""
    cfg = smoke(get_config("dbrx-132b"))
    params = T.init_params(cfg, seed=0, device="cpu")
    srv = Server(cfg, ParallelCtx(moe_impl="esp"), params,
                 ServeConfig(max_seq=8, batch=2), device="cpu")
    logits, cache = srv.prefill(np.ones((2, 6), np.int32))
    tok = torch.zeros((2, 1), dtype=torch.long)
    for _ in range(2):
        logits, cache = srv.decode(tok, cache)
    assert "k" in cache["layers"] and cache["pos"] == 8
    with pytest.raises(RuntimeError, match="past max_seq"):
        srv.decode(tok, cache)
    for call in (lambda: srv.release(0), srv.empty_cache,
                 lambda: srv.prefill_into_slot(0, [1, 2], cache)):
        with pytest.raises(ValueError, match="requires ServeConfig"):
            call()
    with pytest.raises(ValueError, match="moe_impl='ep'"):
        Server(cfg, ParallelCtx(moe_impl="esp"), T.init_params(cfg, seed=0, device="cpu"),
               ServeConfig(max_seq=8, batch=2, virtual_ep=4, slots_per_device=2),
               device="cpu")
