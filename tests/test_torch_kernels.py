"""The port's kernels, held against the JAX package.

On the CPU every kernel wrapper takes its plain PyTorch version; these
tests hold that plain version against the JAX oracle *and* against the
Pallas kernel in interpret mode on tiny shapes (zero tails, groups per
weight, scrambled page tables with NaN-poisoned dead pages, queries at the
tail of the keys, windows). fp32 throughout. The CUDA kernels themselves
run only on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import mha_ref
from repro.kernels.flash_decode.paged import flash_decode_paged as pallas_paged
from repro.kernels.flash_decode.ref import paged_decode_ref
from repro.kernels.gmm.ragged import gmm_dual_act_ragged as pallas_dual
from repro.kernels.gmm.ragged import gmm_ragged as pallas_gmm
from repro.kernels.gmm.ref import expert_ffn_ragged_ref, gmm_ragged_ref
from repro_torch.kernels import registry, tolerance
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode as fd_dense
from repro_torch.kernels.flash_decode import paged as fd_paged
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.flash_decode.paged import flash_decode_paged
from repro_torch.kernels.gmm import ragged as gmm_port
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.kernels.gmm.ragged import gmm_dual_act_ragged, gmm_ragged

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)   # fp32: only summation order differs


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# ragged grouped matmul pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "gpw,counts", [(1, [0, 16, 5, 11]), (2, [3, 0, 16, 1]), (4, [7, 2, 0, 16])]
)
def test_gmm_ragged_plain_matches_jax_and_pallas(gpw, counts):
    rng = np.random.default_rng(0)
    g, c, d, f = 4, 16, 24, 32
    x = rng.standard_normal((g, c, d)).astype(np.float32)
    w = (rng.standard_normal((g // gpw, d, f)) * 0.1).astype(np.float32)
    gs = np.asarray(counts, np.int32)
    want = np.asarray(gmm_ragged_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs), gpw))
    kern = np.asarray(pallas_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                                 groups_per_weight=gpw, bm=8, bn=16, bk=8,
                                 interpret=True))
    got = gmm_ragged(_t(x), _t(w), _t(gs), gpw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, kern, **TOL)
    dead = np.arange(c)[None, :] >= gs[:, None]
    assert (got[dead] == 0).all()


def test_gmm_dual_act_plain_matches_pallas_with_poisoned_tails():
    """Rows past the count are never read: NaN there must not leak."""
    rng = np.random.default_rng(1)
    g, c, d, f = 4, 16, 16, 24
    x = rng.standard_normal((g, c, d)).astype(np.float32)
    wg = (rng.standard_normal((g, d, f)) * 0.1).astype(np.float32)
    wu = (rng.standard_normal((g, d, f)) * 0.1).astype(np.float32)
    gs = np.asarray([0, 16, 5, 9], np.int32)
    kern = np.asarray(pallas_dual(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                                  jnp.asarray(gs), bm=8, bn=8, bk=8, interpret=True))
    poisoned = x.copy()
    poisoned[np.arange(c)[None, :] >= gs[:, None]] = np.nan
    got = gmm_dual_act_ragged(_t(poisoned), _t(wg), _t(wu), _t(gs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, kern, **TOL)


@pytest.mark.parametrize("dual", [False, True])
def test_gmm_decode_split_algebra_matches_pallas(dual):
    """What the decode body's K-split merge relies on: plain fp32 products
    over K ranges, summed in split order with silu applied only after the
    full sum (dual), and rows past the count zero-filled before any
    product, equal the Pallas kernels in interpret mode. Ranges: the
    decode plan's two splits of whole 64-deep stages (a K tail after
    them), and the same with a boundary at k = 37, off the 16-byte vector
    width; a dead group; the Pallas K tile of 137 is off both. fp32,
    (1e-5, 1e-5): only the summation order differs."""
    rng = np.random.default_rng(5)
    g, c, d, f = 4, 8, 1096, 16
    x = rng.standard_normal((g, c, d)).astype(np.float32)
    wg, wu = [(rng.standard_normal((g, d, f)) * 0.05).astype(np.float32) for _ in range(2)]
    gs = np.asarray([3, 0, 8, 1], np.int32)
    live = np.arange(c)[None, :, None] < gs[:, None, None]
    x = np.where(live, x, np.nan).astype(np.float32)   # rows past the count: NaN
    if dual:
        want = pallas_dual(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(gs),
                           bm=8, bn=16, bk=137, interpret=True)
    else:
        want = pallas_gmm(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(gs), bm=8, bn=16,
                          bk=137, interpret=True)
    s = gmm_port.decode_splits(g, d, f, torch.float32)
    nk = -(-d // gmm_port.DECODE_BK)
    edge = -(-nk // s) * gmm_port.DECODE_BK
    assert (s, edge) == (2, 576)
    staged = _t(np.where(live, x, 0.0))        # zero-filled, as the kernel stages them
    for bounds in ([0, edge, d], [0, 37, edge, d]):
        def split_sum(w):
            total = torch.zeros((g, c, f))
            for lo, hi in zip(bounds, bounds[1:]):
                total = total + torch.bmm(staged[:, :, lo:hi], _t(w)[:, lo:hi])
            return total
        a = split_sum(wg)
        got = torch.nn.functional.silu(a) * split_sum(wu) if dual else a
        got = torch.where(_t(live), got, 0.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gmm_decode_plan_from_static_shapes():
    """The decode body's strips and K splits come from shapes alone (and the
    layout: every row live or not). The served forms' splits; every split
    of a plan holds a stage, at most one split per 8 stages; the planning
    step runs on meta tensors, which hold no counts or offsets, and sizes
    the fp32 partials (S x G x C x F a product) and the counters (G x
    strips)."""
    bf, f32 = torch.bfloat16, torch.float32
    assert (gmm_port.decode_strip(bf), gmm_port.decode_strip(f32)) == (128, 64)
    for (g, d, f, every_row), s in [
        ((20, 6144, 10752, False), 1),    # EP / mesh dual
        ((20, 10752, 6144, False), 2),    # EP single, mesh scatter
        ((8, 6144, 16384, False), 2),     # ESP dual gather
        ((8, 16384, 6144, False), 3),     # ESP scatter
        ((20, 6144, 10752, True), 1),     # every row live: all G groups
        ((20, 10752, 6144, True), 1),
        ((6, 1096, 200, False), 2), ((6, 1608, 96, False), 3), ((4, 0, 96, False), 1),
    ]:
        assert gmm_port.decode_splits(g, d, f, bf, every_row) == s
    for nk in range(1, 300):
        for g, f, dt in [(1, 8, bf), (8, 6144, bf), (20, 10752, f32)]:
            s = gmm_port.decode_splits(g, nk * gmm_port.DECODE_BK - 8, f, dt)
            assert (s - 1) * -(-nk // s) < nk                 # the kernel's own check
            assert s == 1 or nk // s >= gmm_port.MIN_SPLIT_STAGES
    meta = dict(device="meta")
    g, c, d, f = 8, 8, 16384, 6144
    x = torch.empty((g, c, d), dtype=bf, **meta)
    w = torch.empty((g, d, f), dtype=bf, **meta)
    gs = torch.empty((g,), dtype=torch.int32, **meta)
    offsets = torch.empty((g,), dtype=torch.int32, **meta)
    out, part, arrived, ints = gmm_port._plan(x, w, None, gs, 1, False, name="gmm_scatter",
                                              offsets=offsets, out_rows=16)
    assert tuple(out.shape) == (16, f) and ints[-1] == 3
    assert part.numel() == 3 * g * c * f and arrived.numel() >= g * f // 128
    x = torch.empty((20, 8, 6144), dtype=bf, **meta)
    w = torch.empty((20, 6144, 10752), dtype=bf, **meta)
    out, part, arrived, ints = gmm_port._plan(x, w, w, None, 1, True, name="gmm_dual_act")
    assert tuple(out.shape) == (20, 8, 10752) and ints[-1] == 1
    assert part is None and arrived is None
    flat = torch.empty((16, 6144), dtype=bf, **meta)
    w = torch.empty((8, 6144, 16384), dtype=bf, **meta)
    out, part, arrived, ints = gmm_port._plan(flat, w, w, gs, 1, True,
                                              name="gmm_dual_act_gather", capacity=8,
                                              offsets=offsets)
    assert tuple(out.shape) == (8, 8, 16384) and ints[-1] == 2
    assert part.numel() == 2 * 2 * 8 * 8 * 16384
    # prefill capacity: the wgmma body, no split
    x = torch.empty((20, 820, 6144), dtype=bf, **meta)
    w = torch.empty((20, 6144, 10752), dtype=bf, **meta)
    gs = torch.empty((20,), dtype=torch.int32, **meta)
    assert gmm_port._plan(x, w, w, gs, 1, True, name="gmm_dual_act_ragged")[1:] == (
        None, None, (20, 820, 6144, 10752, 1, 0, 0, 1, 1, 1))


@pytest.mark.parametrize("gpw", [1, 2])
def test_expert_ffn_plain_matches_jax(gpw):
    rng = np.random.default_rng(2)
    g, c, d, f = 4, 8, 16, 12
    x = rng.standard_normal((g, c, d)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((g // gpw, d, f), (g // gpw, d, f), (g // gpw, f, d))]
    gs = np.asarray([8, 0, 3, 6], np.int32)
    want = np.asarray(expert_ffn_ragged_ref(jnp.asarray(x), *map(jnp.asarray, ws),
                                            jnp.asarray(gs), gpw))
    got = registry.expert_ffn(_t(x), *map(_t, ws), _t(gs), gpw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    same = gmm_ref.expert_ffn_ragged(_t(x), *map(_t, ws), _t(gs), gpw)
    assert torch.equal(got, same)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths", [[37, 16, 1], [64, 63, 17]])
def test_paged_decode_plain_matches_jax_and_pallas(lengths):
    """Scrambled page tables; the port's plain version sees NaN in every
    dead row and dead page (the JAX oracle and the Pallas kernel get the
    clean pool: the oracle's masked PV product is not NaN-safe)."""
    rng = np.random.default_rng(3)
    b, nb, bs, h, kv, hd = 3, 4, 16, 8, 2, 16
    p = b * nb + 1
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    pk = rng.standard_normal((p, bs, kv, hd)).astype(np.float32)
    pv = rng.standard_normal((p, bs, kv, hd)).astype(np.float32)
    tables = rng.permutation(p)[: b * nb].reshape(b, nb).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    args = [jnp.asarray(a) for a in (q, pk, pv, tables, ln)]
    want = np.asarray(paged_decode_ref(*args))
    kern = np.asarray(pallas_paged(*args, interpret=True))
    pk_bad, pv_bad = pk.copy(), pv.copy()
    for i in range(b):
        for j in range(nb):
            lo = max(0, ln[i] - j * bs)
            if lo < bs:
                pk_bad[tables[i, j], lo:] = np.nan
                pv_bad[tables[i, j], lo:] = np.nan
    got = flash_decode_paged(_t(q), _t(pk_bad), _t(pv_bad), _t(tables), _t(ln)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, kern, **TOL)
    assert registry.decode_attend_paged is flash_decode_paged


def test_dense_decode_masks_with_where():
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.standard_normal((2, 4, 8)).astype(np.float32))
    k = torch.tensor(rng.standard_normal((2, 6, 2, 8)).astype(np.float32))
    v = k.clone()
    valid = torch.tensor([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1]], dtype=torch.bool)
    k2, v2 = k.clone(), v.clone()
    k2[0, 3:] = float("nan")
    v2[0, 3:] = float("nan")
    np.testing.assert_array_equal(fd_ref.decode(q, k, v, valid).numpy(),
                                  fd_ref.decode(q, k2, v2, valid).numpy())


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "s,t,window,causal",
    [(32, 32, 0, True), (16, 48, 0, True), (24, 40, 8, True), (32, 32, 0, False)],
)
def test_mha_plain_matches_jax_and_pallas(s, t, window, causal):
    rng = np.random.default_rng(5)
    b, h, kv, hd = 2, 4, 2, 16
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(mha_ref(jq, jk, jv, causal=causal, window=window))
    kern = np.asarray(pallas_flash(jq, jk, jv, causal=causal, window=window,
                                   bq=8, bk=8, interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, kern, **TOL)
    # the registry's attend is flash_attention under its autograd Function
    assert torch.equal(registry.attend(_t(q), _t(k), _t(v), causal=causal, window=window),
                       torch.tensor(got))
    assert torch.equal(torch.tensor(got), fa_ref.mha(_t(q), _t(k), _t(v), causal, window))


def test_gates_take_every_serving_shape():
    """The served paths' shapes pass every Hopper gate (bf16 and fp32): the
    DBRX and Mixtral widths, 48 query heads over 8 KV heads of 128, pages
    of 128, a dense cache of 1024 slots. The decode gates hold the split
    block's shared memory (K and V tiles of 64 keys, the q panel and p at
    the padded group), the group (at most 16) and the head dim (a
    multiple of 32 up to 256). The footprint's bytes are the kernels' own
    (``chip_smoke.py`` holds the two counts equal on the card)."""
    for dt in (torch.bfloat16, torch.float32):
        assert registry.can_gmm(6144, 10752, dt) and registry.can_gmm(10752, 6144, dt)
        assert registry.can_flash_decode_paged(128, 48, 8, 128, dt)
        assert registry.can_flash_decode(1024, 48, 8, 128, dt)
        assert registry.can_flash_attend(256, 256, 48, 8, 128, dt)
        # the widest group and head dim the gates take fit one block
        assert registry.can_flash_decode_paged(32, 32, 2, 256, dt)
        assert registry.can_flash_decode(64, 32, 2, 256, dt)
        assert fd_paged.smem_bytes(16, 256, dt) <= fd_paged.SMEM_LIMIT
    assert fd_paged.smem_bytes(6, 128, torch.bfloat16) == 41168
    assert fd_paged.smem_bytes(6, 128, torch.float32) == 76752
    assert not registry.can_gmm(6144, 10752, torch.float16)
    assert not registry.can_flash_decode_paged(128, 48, 8, 100, torch.float32)
    assert not registry.can_flash_decode_paged(128, 34, 2, 128, torch.bfloat16)   # G 17
    assert not registry.can_flash_decode(1024, 8, 2, 288, torch.bfloat16)         # hd 288
    assert not registry.can_flash_decode(1024, 48, 8, 128, torch.float16)
    assert not registry.can_flash_attend(256, 128, 48, 8, 128, torch.float32)


def test_decode_split_count_from_static_shapes():
    """The decode wrappers size their split grid and scratch from shapes
    alone: S = ceil(slots / 64) up to 32. Their planning step runs on meta
    tensors, which hold no values, so it reads neither the lengths, the
    tables nor the mask."""
    for slots, s in [(1, 1), (63, 1), (64, 1), (65, 2), (200, 4), (1024, 16),
                     (2048, 32), (2560, 32)]:
        assert fd_paged.split_count(slots) == s
    meta = dict(device="meta")
    b, h, kv, hd = 8, 48, 8, 128
    q = torch.empty((b, h, hd), dtype=torch.bfloat16, **meta)
    for t, s in [(1024, 16), (200, 4)]:
        k = torch.empty((b, t, kv, hd), dtype=torch.bfloat16, **meta)
        valid = torch.empty((b, t), dtype=torch.int32, **meta)
        for partials in (False, True):
            outs, scratch, arrived, ints = fd_dense._plan(q, k, k, valid, partials=partials,
                                                          name="flash_decode")
            assert ints == (b, h, kv, hd, t, s, 1)
            assert scratch.numel() == s * b * h * (hd + 2) and arrived.numel() >= b * kv
            want = [(b, h, hd), (b, h), (b, h)] if partials else [(b, h, hd)]
            assert [tuple(o.shape) for o in outs] == want
    for bs, nb, s in [(128, 8, 16), (32, 4, 2)]:
        pool = torch.empty((b * nb + 1, bs, kv, hd), dtype=torch.bfloat16, **meta)
        tables = torch.empty((b, nb), dtype=torch.int32, **meta)
        lengths = torch.empty((b,), dtype=torch.int32, **meta)
        outs, scratch, _, ints = fd_paged._plan(q, pool, pool, tables, lengths,
                                                partials=True, name="flash_decode_paged")
        assert ints == (b, h, kv, hd, bs, nb, s, 1)
        assert scratch.numel() == s * b * h * (hd + 2)


def test_tolerance_is_elementwise_and_exact_on_dead_rows():
    """The on-card limit: each element against rtol |want| + atol rms(row);
    an all-zero (dead) row must match exactly; NaN never passes."""
    want = torch.tensor([[1.0, -2.0, 0.0, 4.0], [0.0, 0.0, 0.0, 0.0]])
    rtol, atol = tolerance.PLAIN[torch.bfloat16]
    rms = float(want[0].square().mean().sqrt())
    near = want.clone()
    near[0, 2] = 0.9 * atol * rms          # a zero of the row, within the rms term
    near[0, 3] = 4.0 * (1 + 0.9 * rtol)
    assert tolerance.excess(near, want, rtol, atol) <= 1.0
    assert tolerance.excess(want, want, rtol, atol) == 0.0
    off = want.clone()
    off[0, 1] = -2.2                       # 10% off one element
    assert tolerance.excess(off, want, rtol, atol) > 1.0
    dead = want.clone()
    dead[1, 0] = 1e-6
    assert tolerance.excess(dead, want, rtol, atol) == float("inf")
    nan = want.clone()
    nan[0, 0] = float("nan")
    assert tolerance.excess(nan, want, rtol, atol) == float("inf")
