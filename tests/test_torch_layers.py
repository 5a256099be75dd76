"""Layer primitives, routing and attention of the port against the JAX
package, at ``smoke(dbrx-132b)`` width, fp32 (tolerance 1e-5: only the
summation order differs)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JM
from repro.parallel.ctx import ParallelCtx as JCtx
from repro_torch.configs import ARCHS, get_config, smoke
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.parallel.ctx import ParallelCtx

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = smoke(get_config("dbrx-132b"))
JCFG = jsmoke(jget("dbrx-132b"))


def _t(a):
    return torch.tensor(np.asarray(a))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Every arch of the reference, field for field, and its smoke()."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget(arch))
    assert dataclasses.asdict(smoke(get_config(arch))) == dataclasses.asdict(jsmoke(jget(arch)))


def test_rms_norm_rope_mlp():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64)
    w = _rand(rng, 64)
    np.testing.assert_allclose(L.rms_norm(_t(x), _t(w)).numpy(),
                               np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    q = _rand(rng, 2, 5, 4, 16)
    pos = rng.integers(0, 300, (2, 5))
    np.testing.assert_allclose(
        L.apply_rope(_t(q), _t(pos), 10000.0).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 10000.0)), **TOL)
    np.testing.assert_allclose(L.rope_freqs(16, 10000.0).numpy(),
                               np.asarray(JL.rope_freqs(16, 10000.0)), **TOL)
    p = {k: _rand(rng, *s, scale=0.1) for k, s in
         (("w_gate", (64, 32)), ("w_up", (64, 32)), ("w_down", (32, 64)))}
    np.testing.assert_allclose(
        L.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x)).numpy(),
        np.asarray(JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), JCtx())), **TOL)


def _moe_params(rng):
    e, d, f = CFG.n_experts, CFG.d_model, CFG.moe_d_ff_
    return {"router": _rand(rng, d, e, scale=0.5), "w_gate": _rand(rng, e, d, f, scale=0.1),
            "w_up": _rand(rng, e, d, f, scale=0.1), "w_down": _rand(rng, e, f, d, scale=0.1)}


def test_route_and_dense_moe_with_token_mask():
    rng = np.random.default_rng(1)
    p = _moe_params(rng)
    x = _rand(rng, 4, 3, CFG.d_model)
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ids, w, aux = M.route(tp, _t(x), CFG)
    jids, jw, jaux = JM.route(jp, jnp.asarray(x), JCFG)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    mask = np.asarray([True, False, True, True])[:, None].repeat(3, 1)
    out, a = M.moe_dense(tp, _t(x), CFG, ParallelCtx(), token_mask=_t(mask))
    jout, ja = JM.moe_dense(jp, jnp.asarray(x), JCFG, JCtx(), token_mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(a["counts"].numpy(), np.asarray(ja["counts"]))
    assert (out[1] == 0).all()


@pytest.mark.parametrize("ep_chunks", [1, 2])
def test_moe_ep_matches_reference(ep_chunks):
    rng = np.random.default_rng(2)
    p = _moe_params(rng)
    x = _rand(rng, 3, 4, CFG.d_model)
    mask = np.asarray([True, True, False])[:, None].repeat(4, 1)
    out, a = M.moe_ep({k: _t(v) for k, v in p.items()}, _t(x), CFG,
                      ParallelCtx(capacity_factor=1.0, ep_chunks=ep_chunks),
                      slots_per_device=6, token_mask=_t(mask))
    jout, ja = JM.moe_ep({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), JCFG,
                         JCtx(capacity_factor=1.0, use_kernels=False),
                         slots_per_device=6, token_mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(a["counts"].numpy(), np.asarray(ja["counts"]))


def _attn_params(rng):
    d, h = CFG.d_model, CFG.head_dim_
    return {"wq": _rand(rng, d, CFG.n_heads * h, scale=0.2),
            "wk": _rand(rng, d, CFG.n_kv_heads * h, scale=0.2),
            "wv": _rand(rng, d, CFG.n_kv_heads * h, scale=0.2),
            "wo": _rand(rng, CFG.n_heads * h, d, scale=0.2)}


@pytest.mark.parametrize("window", [0, 6])
def test_attention_prefill_matches_reference(window):
    cfg = dataclasses.replace(CFG, sliding_window=window)
    jcfg = dataclasses.replace(JCFG, sliding_window=window)
    rng = np.random.default_rng(3)
    p = _attn_params(rng)
    x = _rand(rng, 2, 11, cfg.d_model)
    out, (k, v) = A.attention({n: _t(a) for n, a in p.items()}, _t(x), cfg,
                              ParallelCtx(), return_kv=True)
    jout, (jk, jv) = JA.attention({n: jnp.asarray(a) for n, a in p.items()},
                                  jnp.asarray(x), jcfg, JCtx(), return_kv=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_chunked_gqa_attend_matches_reference(causal, window):
    rng = np.random.default_rng(4)
    q = _rand(rng, 1, 32, 4, 8)
    k = _rand(rng, 1, 64, 2, 8)
    v = _rand(rng, 1, 64, 2, 8)
    got = A.chunked_gqa_attend(_t(q), _t(k), _t(v), causal, window, chunk=16)
    want = JA.chunked_gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal, window, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mask = A.causal_mask(32, 64, window, offset=32).numpy()
    np.testing.assert_array_equal(mask, np.asarray(JA.causal_mask(32, 64, window, offset=32)))
