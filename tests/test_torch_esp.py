"""The ESP expert path of the port against the JAX package: the flat-row
kernels' plain versions (gather, scatter, fused FFN) against the Pallas
kernels in interpret mode, the registry's gates and row FFN, the
metadata-driven combine, ``moe_esp`` in both branches, and ``Server``
serving ESP on a dense cache. fp32 on the CPU; live rows within 1e-5,
greedy tokens exactly. The port's inputs carry NaN in every gap row (rows
of dropped copies between bucket segments) and its flat outputs start as
NaN: live rows must match and every other row must stay NaN (no spill).
The CUDA kernels run on the card (``tests/test_torch_cuda.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.kernels import registry as jreg
from repro.kernels.gmm.ops import expert_ffn_fused, gmm_scatter_op
from repro.kernels.gmm.ragged import gmm_dual_act_gather as pallas_dual_gather
from repro.models import transformer as JT
from repro.models.moe import moe_esp as jmoe_esp
from repro.models.moe import moe_init as jmoe_init
from repro.parallel import collectives as JC
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.runtime.serve import ServeConfig as JServeConfig
from repro.runtime.serve import Server as JServer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke
from repro_torch.kernels import registry
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.kernels.gmm.ragged import gmm_dual_act_gather, gmm_fused_ffn, gmm_scatter
from repro_torch.models.moe import moe_esp
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime.serve import ServeConfig, Server

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


def _layout(counts, gap, cap):
    """Offsets of bucket segments with ``gap`` rows between them (dropped
    copies), the flat row count and the live-row mask. A count above the
    capacity keeps its pre-capacity rows, as ``dispatch_metadata`` does."""
    offsets, pos = [], 0
    for c in counts:
        offsets.append(pos)
        pos += c + gap
    live = np.zeros(max(pos, 1), bool)
    for o, c in zip(offsets, counts):
        live[o : o + min(c, cap)] = True
    return np.asarray(offsets, np.int32), max(pos, 1), live


# (G, capacity, D, F, groups_per_weight, counts, gap rows between segments)
CELLS = [
    (4, 16, 8, 12, 1, [3, 0, 16, 5], 0),        # empty and full groups, no gaps
    (4, 16, 8, 12, 2, [5, 0, 9, 20], 3),        # gpw 2, gaps, one over capacity
    (6, 8, 16, 24, 3, [8, 2, 0, 1, 7, 3], 1),   # gpw 3, decode-sized capacity
]


@pytest.mark.parametrize("g,cap,d,f,gpw,counts,gap", CELLS)
def test_flat_row_kernels_plain_match_pallas(g, cap, d, f, gpw, counts, gap):
    rng = np.random.default_rng(g + gap)
    offsets, r, live = _layout(counts, gap, cap)
    gs = np.minimum(np.asarray(counts, np.int32), cap)
    x = rng.standard_normal((r, d)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.2).astype(np.float32)
          for s in ((g // gpw, d, f), (g // gpw, d, f), (g // gpw, f, d))]
    jx, (jg, ju, jd) = jnp.asarray(x), map(jnp.asarray, ws)
    joff, jgs = jnp.asarray(offsets), jnp.asarray(np.asarray(counts, np.int32))
    poisoned = x.copy()
    poisoned[~live] = np.nan
    xp, (wg, wu, wd), off, gst = _t(poisoned), map(_t, ws), _t(offsets), _t(gs)

    # gather prologue: padded (G, cap, F) output, zero tails
    want_h = np.asarray(pallas_dual_gather(jx, jg, ju, joff, jgs, capacity=cap,
                                           groups_per_weight=gpw, interpret=True))
    h = gmm_dual_act_gather(xp, wg, wu, off, gst, cap, gpw)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)
    assert (h.numpy()[np.arange(cap)[None, :] >= gs[:, None]] == 0).all()

    # scatter epilogue: only live rows written, the rest keep the NaN
    want_y = np.asarray(gmm_scatter_op(jnp.asarray(want_h), jd, joff, jgs, out_rows=r,
                                       groups_per_weight=gpw))
    y = gmm_scatter(h, wd, off, gst, r, gpw, out=torch.full((r, d), float("nan")))
    np.testing.assert_allclose(y.numpy()[live], want_y[live], **TOL)
    assert np.isnan(y.numpy()[~live]).all()

    # one-kernel FFN: the pair, and the JAX fused kernel on live rows
    want_f = np.asarray(expert_ffn_fused(jx, jg, ju, jd, joff, jgs, capacity=cap,
                                         groups_per_weight=gpw))
    fused = gmm_fused_ffn(xp, wg, wu, wd, off, gst, cap, gpw,
                          out=torch.full((r, d), float("nan")))
    np.testing.assert_allclose(fused.numpy()[live], want_f[live], **TOL)
    assert np.isnan(fused.numpy()[~live]).all()
    assert torch.equal(fused[live], y[live])
    zeros = gmm_ref.expert_ffn_compact(xp, wg, wu, wd, off, gst, cap, gpw)
    assert (zeros.numpy()[~live] == 0).all()   # default out: the oracle's zeros


def test_gates_make_the_reference_decision():
    """Fused-or-pair at the test shapes (the reference in interpret mode)
    and at model widths (compiled): the same answer everywhere, so
    mixtral's d_model 6144 takes the pair and 4096 the fused kernel."""
    shapes = [(16, 8, 12, None), (8, 16, 24, None), (16, 64, 96, None),
              (8, 16, 24, 4096), (8, 16, 24, 4104)]
    for cap, d, f, d_out in shapes:
        assert registry.can_gmm_fused(cap, d, f, torch.float32, d_out) == \
            jreg.can_gmm_fused(cap, d, f, True, d_out)
        assert registry.can_gmm_gather(cap, d, f, torch.float32) == \
            jreg.can_gmm_gather(cap, d, f, True)
    for cap, d, f in [(8, 6144, 16384), (1024, 6144, 16384), (8, 4096, 16384),
                      (1024, 4096, 14336), (8, 6144, 10752)]:
        for dt in (torch.bfloat16, torch.float32):
            assert registry.can_gmm_fused(cap, d, f, dt) == \
                jreg.can_gmm_fused(cap, d, f, False)
            assert registry.can_gmm_gather(cap, d, f, dt) == \
                jreg.can_gmm_gather(cap, d, f, False)
    assert not registry.can_gmm_fused(8, 6144, 16384, torch.bfloat16)
    assert registry.can_gmm_fused(8, 4096, 16384, torch.bfloat16)


@pytest.mark.parametrize("compact_out,fused", [(False, False), (True, False), (True, True)])
def test_expert_ffn_from_rows_matches_reference(compact_out, fused):
    g, cap, d, f, gpw, counts, gap = CELLS[1]
    rng = np.random.default_rng(5)
    offsets, r, live = _layout(counts, gap, cap)
    x = rng.standard_normal((r, d)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.2).astype(np.float32)
          for s in ((g // gpw, d, f), (g // gpw, d, f), (g // gpw, f, d))]
    gs = np.asarray(counts, np.int32)
    want = np.asarray(jreg.expert_ffn_from_rows(
        jnp.asarray(x), *map(jnp.asarray, ws), jnp.asarray(offsets), jnp.asarray(gs),
        capacity=cap, groups_per_weight=gpw, compact_out=compact_out, fused=fused))
    got = registry.expert_ffn_from_rows(
        _t(x), *map(_t, ws), _t(offsets), _t(np.minimum(gs, cap)), capacity=cap,
        groups_per_weight=gpw, compact_out=compact_out, fused=fused).numpy()
    if compact_out:
        np.testing.assert_allclose(got[live], want[live], **TOL)
    else:
        np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="requires compact_out"):
        registry.expert_ffn_from_rows(_t(x), *map(_t, ws), _t(offsets), _t(gs),
                                      capacity=cap, groups_per_weight=gpw, fused=True)


def test_combine_from_rows_is_nan_safe_and_matches_reference():
    rng = np.random.default_rng(6)
    n, k, e, cap, d = 12, 2, 3, 4, 8
    ids = rng.integers(0, e, (n, k)).astype(np.int32)
    ids[0, 1] = e                                      # a masked copy
    _, offsets, _, slots, keep = C.dispatch_metadata(_t(ids), e, cap)
    rows = offsets[_t(ids).long().clamp(max=e - 1)] + slots
    y = rng.standard_normal((n * k, d)).astype(np.float32)
    live = np.zeros(n * k, bool)
    live[rows.numpy()[keep.numpy()]] = True
    assert (~keep.numpy()).sum() >= 2 and not live.all()
    y_bad = y.copy()
    y_bad[~live] = np.nan
    wts = rng.random((n, k)).astype(np.float32)
    got = C.combine_from_rows(_t(y_bad), rows, keep, _t(wts))
    want = JC.combine_from_rows(jnp.asarray(y_bad), jnp.asarray(rows.numpy()),
                                jnp.asarray(keep.numpy()), jnp.asarray(wts))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def moe_setup():
    jcfg = dataclasses.replace(jsmoke(jget("dbrx-132b")), n_experts=4, experts_per_token=2)
    cfg = dataclasses.replace(smoke(get_config("dbrx-132b")), n_experts=4,
                              experts_per_token=2)
    p = jmoe_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("shape,cf", [((2, 8), 1.0), ((2, 8), 8.0), ((4, 1), 2.0)],
                         ids=["prefill-drops", "prefill", "decode"])
def test_moe_esp_both_branches_match_reference(moe_setup, shape, cf):
    """The flat-row branch against the reference with kernels on (Pallas
    interpret), the padded branch against it with kernels off; masked
    tokens route nowhere; ep_chunks 2 and 4 are bit-identical to 1."""
    jcfg, cfg, jp, p = moe_setup
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((*shape, cfg.d_model)) * 0.5).astype(np.float32)
    mask = np.ones(shape, bool)
    mask[0, 0] = False
    want_on, _ = jmoe_esp(jp, jnp.asarray(x), jcfg, JCtx(capacity_factor=cf,
                                                          use_kernels=True),
                          token_mask=jnp.asarray(mask))
    want_off, _ = jmoe_esp(jp, jnp.asarray(x), jcfg, JCtx(capacity_factor=cf,
                                                           use_kernels=False),
                           token_mask=jnp.asarray(mask))
    outs = [moe_esp(p, _t(x), cfg, ParallelCtx(capacity_factor=cf, ep_chunks=kc),
                    token_mask=_t(mask))[0] for kc in (1, 2, 4)]
    off, aux = moe_esp(p, _t(x), cfg, ParallelCtx(capacity_factor=cf, use_kernels=False),
                       token_mask=_t(mask))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want_on), **TOL)
    np.testing.assert_allclose(off.numpy(), np.asarray(want_off), **TOL)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert float(aux["counts"].sum()) == (mask.sum()) * cfg.experts_per_token
    with pytest.raises(ValueError, match="does not divide"):
        moe_esp(p, _t(x), cfg, ParallelCtx(ep_chunks=3))


@pytest.mark.parametrize("arch,prompt_len,n_new", [("dbrx-132b", 6, 8),
                                                   ("mixtral-8x22b", 20, 16)])
def test_server_esp_dense_matches_reference(arch, prompt_len, n_new):
    """``Server`` with ESP on the dense cache against the JAX ``Server``
    on bridged weights: the same greedy tokens. Mixtral's smoke window (32)
    is wrapped: prompt + new tokens > 32."""
    jcfg, cfg = jsmoke(jget(arch)), smoke(get_config(arch))
    assert (cfg.sliding_window == 32) == (arch == "mixtral-8x22b")
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               (3, prompt_len)).astype(np.int32)
    kw = dict(max_seq=48, batch=3)
    js = JServer(jcfg, JCtx(moe_impl="esp"), jparams, JServeConfig(**kw))
    want = np.asarray(js.generate(jnp.asarray(prompt), n_new))
    srv = Server(cfg, ParallelCtx(moe_impl="esp"), params_from_numpy(np_params),
                 ServeConfig(paged=False, **kw), device="cpu")
    got = srv.generate(prompt, n_new)
    np.testing.assert_array_equal(got.numpy(), want)
    if cfg.sliding_window:
        assert prompt_len + n_new > cfg.sliding_window
