"""The port's kernel op layer, held against the JAX package's.

Every function of ``repro_torch.kernels.{gmm,flash_decode,flash_attention}.ops``
(and the paged decode's ``return_partials`` mode) against its JAX
counterpart, the Pallas kernels in interpret mode, on the same numpy-seeded
inputs. On the CPU the port's wrappers take their plain versions; the CUDA
kernels run only on the card (``tests/test_torch_cuda.py``). The cases
mirror the reference's own: ``test_kernels.py`` (gmm_op, the padded
expert_ffn), ``test_fused_dispatch.py`` (gmm_gather_op) and
``test_paged_decode.py`` (paged partials and their merge).

Tolerances: fp32 (1e-5, 1e-5), summation order only; (1e-4, 1e-4) where a
result passes through two products or an exp-sum (the FFNs, the partials'
``l`` and ``acc``), as the reference's tests state them. bf16 is held
elementwise at the port's bf16 limit (``tolerance.PLAIN``): both sides
round their output, the plain one also its products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_decode import ops as jfd_ops
from repro.kernels.flash_decode.paged import flash_decode_paged as jax_paged
from repro.kernels.gmm import ops as jgmm_ops
from repro_torch.kernels import tolerance
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.flash_decode.paged import (
    flash_decode_paged,
    flash_decode_paged_partials,
)
from repro_torch.kernels.gmm import gmm as gmm_mod
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm import ragged

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
TOL2 = dict(rtol=1e-4, atol=1e-4)
NEG_INF = -1e30


def _t(a):
    return torch.tensor(np.asarray(a))


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a)).astype(dtype)


def _pair(a, dtype):
    """One numpy array as the port's and JAX's input in ``dtype`` (bf16
    rounded once, in torch, so both sides hold the same values)."""
    t = torch.tensor(a).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return t, _j(t.float().numpy(), jdt)


def _close(got: torch.Tensor, want, dtype, tol=TOL):
    want = np.asarray(want, np.float32)
    if dtype == torch.bfloat16:
        ex = tolerance.excess(got.float(), torch.tensor(want), *tolerance.PLAIN[dtype])
        assert ex <= 1.0, ex
    else:
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _segments(counts, pad_between=0):
    """Flat row count and bucket offsets with ``pad_between`` junk rows
    between segments (``test_fused_dispatch.py``'s layout)."""
    offsets, pos = [], 0
    for c in counts:
        offsets.append(pos)
        pos += int(c) + pad_between
    return pos, np.asarray(offsets, np.int32)


# ---------------------------------------------------------------------------
# padded grouped matmul: gmm_op, expert_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "g,c,d,f",
    [(1, 8, 8, 8), (4, 64, 32, 48), (2, 128, 128, 256), (3, 96, 64, 160)],
)
def test_gmm_op_matches_jax(g, c, d, f, dtype):
    rng = np.random.default_rng(0)
    x, jx = _pair(rng.standard_normal((g, c, d)).astype(np.float32), dtype)
    w, jw = _pair((rng.standard_normal((g, d, f)) * 0.1).astype(np.float32), dtype)
    got = gmm_ops.gmm_op(x, w)
    assert got.shape == (g, c, f) and got.dtype == dtype
    _close(got, jgmm_ops.gmm_op(jx, jw).astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_dual_act_matches_jax(dtype):
    from repro.kernels.gmm.gmm import gmm_dual_act as jax_dual

    rng = np.random.default_rng(1)
    g, c, d, f = 3, 24, 32, 48
    x, jx = _pair(rng.standard_normal((g, c, d)).astype(np.float32), dtype)
    wg, jwg = _pair((rng.standard_normal((g, d, f)) * 0.1).astype(np.float32), dtype)
    wu, jwu = _pair((rng.standard_normal((g, d, f)) * 0.1).astype(np.float32), dtype)
    got = gmm_mod.gmm_dual_act(x, wg, wu)
    want = jax_dual(jx, jwg, jwu, bm=8, bn=16, bk=8, interpret=True)
    _close(got, want.astype(jnp.float32), dtype, TOL2)


@pytest.mark.parametrize("g,c,d,f", [(2, 32, 16, 24), (4, 128, 64, 128)])
def test_expert_ffn_padded_matches_jax(g, c, d, f):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((g, c, d)).astype(np.float32)
    wg, wu = ((rng.standard_normal((g, d, f)) * 0.1).astype(np.float32) for _ in range(2))
    wd = (rng.standard_normal((g, f, d)) * 0.1).astype(np.float32)
    got = gmm_ops.expert_ffn(_t(x), _t(wg), _t(wu), _t(wd))
    want = jgmm_ops.expert_ffn(_j(x), _j(wg), _j(wu), _j(wd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL2)


# ---------------------------------------------------------------------------
# ragged forms: gmm_ragged_op, expert_ffn_ragged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gpw,counts", [(1, [0, 16, 5, 11]), (2, [3, 0, 16, 1])])
def test_ragged_ops_match_jax(gpw, counts):
    rng = np.random.default_rng(3)
    g, c, d, f = 4, 16, 24, 32
    x = rng.standard_normal((g, c, d)).astype(np.float32)
    wg, wu = ((rng.standard_normal((g // gpw, d, f)) * 0.1).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((g // gpw, f, d)) * 0.1).astype(np.float32)
    gs = np.asarray(counts, np.int32)
    got = gmm_ops.gmm_ragged_op(_t(x), _t(wg), _t(gs), gpw)
    want = jgmm_ops.gmm_ragged_op(_j(x), _j(wg), jnp.asarray(gs), groups_per_weight=gpw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = gmm_ops.expert_ffn_ragged(_t(x), _t(wg), _t(wu), _t(wd), _t(gs), gpw)
    want = jgmm_ops.expert_ffn_ragged(_j(x), _j(wg), _j(wu), _j(wd), jnp.asarray(gs),
                                      groups_per_weight=gpw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL2)


# ---------------------------------------------------------------------------
# gmm_gather_op (test_fused_dispatch.py's cases)
# ---------------------------------------------------------------------------

def _gather_case(counts, d, f, gpw=1, pad_between=0, seed=4):
    g = len(counts)
    r, offsets = _segments(counts, pad_between)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((max(r, 1), d)).astype(np.float32)
    w = (rng.standard_normal((g // gpw, d, f)) * 0.1).astype(np.float32)
    return x, w, offsets, np.asarray(counts, np.int32)


@pytest.mark.parametrize(
    "cap,d,f,counts",
    [
        (16, 8, 12, [3, 0, 16, 5]),          # zero group, full group
        (96, 64, 160, [1, 95, 40]),          # non-128 C/D/F
        (128, 128, 256, [128, 17]),          # whole tiles
        (24, 48, 40, [24, 0, 0, 7, 2]),      # several empty groups
        (128, 16, 24, [100, 29]),            # the last segment ends at R = 129
    ],
)
def test_gmm_gather_op_matches_jax(cap, d, f, counts):
    x, w, offsets, gs = _gather_case(counts, d, f)
    got = gmm_ops.gmm_gather_op(_t(x), _t(w), _t(offsets), _t(gs), cap)
    want = np.asarray(jgmm_ops.gmm_gather_op(_j(x), _j(w), jnp.asarray(offsets),
                                             jnp.asarray(gs), capacity=cap))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for gi, cnt in enumerate(counts):
        assert (got[gi, cnt:] == 0).all()


def test_gmm_gather_op_noncontiguous_nan_segments():
    """Junk rows between segments hold NaN: never read (the live rows agree
    with JAX's, the tails are exact zeros)."""
    cap, d, f, counts = 16, 8, 12, [5, 0, 9]
    x, w, offsets, gs = _gather_case(counts, d, f, pad_between=3)
    live = np.zeros(x.shape[0], bool)
    for off, cnt in zip(offsets, counts):
        live[off : off + cnt] = True
    x[~live] = np.nan
    got = gmm_ops.gmm_gather_op(_t(x), _t(w), _t(offsets), _t(gs), cap).numpy()
    want = np.asarray(jgmm_ops.gmm_gather_op(_j(x), _j(w), jnp.asarray(offsets),
                                             jnp.asarray(gs), capacity=cap))
    for gi, cnt in enumerate(counts):
        assert np.isfinite(got[gi]).all() and (got[gi, cnt:] == 0).all()
        np.testing.assert_allclose(got[gi, :cnt], want[gi, :cnt], **TOL)


@pytest.mark.parametrize("gpw", [2, 4])
def test_gmm_gather_op_groups_per_weight(gpw):
    cap, d, f = 16, 24, 20
    counts = [(3 * i) % (cap + 1) for i in range(2 * gpw)]
    x, w, offsets, gs = _gather_case(counts, d, f, gpw=gpw)
    got = gmm_ops.gmm_gather_op(_t(x), _t(w), _t(offsets), _t(gs), cap, gpw)
    want = jgmm_ops.gmm_gather_op(_j(x), _j(w), jnp.asarray(offsets), jnp.asarray(gs),
                                  capacity=cap, groups_per_weight=gpw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the flat-row FFNs: expert_ffn_gather, gmm_scatter_op,
# expert_ffn_gather_compact, expert_ffn_fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gpw", [1, 2])
@pytest.mark.parametrize(
    "name", ["expert_ffn_gather", "gmm_scatter_op", "expert_ffn_gather_compact",
             "expert_ffn_fused"],
)
def test_flat_row_ops_match_jax(name, gpw):
    cap, d, f = 16, 16, 24
    counts = [5, 0, 16, 9]
    g = len(counts)
    r, offsets = _segments(counts, pad_between=2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((r, d)).astype(np.float32)
    wg, wu = ((rng.standard_normal((g // gpw, d, f)) * 0.1).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((g // gpw, f, d)) * 0.1).astype(np.float32)
    gs = np.asarray(counts, np.int32)
    off_t, gs_t, off_j, gs_j = _t(offsets), _t(gs), jnp.asarray(offsets), jnp.asarray(gs)
    live = np.zeros(r, bool)
    for o, c in zip(offsets, counts):
        live[o : o + c] = True
    if name == "gmm_scatter_op":
        h = (rng.standard_normal((g, cap, f)) * 0.5).astype(np.float32)
        got = gmm_ops.gmm_scatter_op(_t(h), _t(wd), off_t, gs_t, r, gpw)
        want = jgmm_ops.gmm_scatter_op(_j(h), _j(wd), off_j, gs_j, out_rows=r,
                                       groups_per_weight=gpw)
    else:
        args_t = (_t(x), _t(wg), _t(wu), _t(wd), off_t, gs_t, cap, gpw)
        got = getattr(gmm_ops, name)(*args_t)
        want = getattr(jgmm_ops, name)(_j(x), _j(wg), _j(wu), _j(wd), off_j, gs_j,
                                       capacity=cap, groups_per_weight=gpw)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if name == "expert_ffn_gather":      # bucket-padded out: every row
        np.testing.assert_allclose(got, want, **TOL2)
    else:                                # flat out: the live segments; the
        np.testing.assert_allclose(got[live], want[live], **TOL2)
        assert (got[~live] == 0).all()   # rest as the plain version leaves it


# ---------------------------------------------------------------------------
# decode and attention ops
# ---------------------------------------------------------------------------

def _dense_decode_case(seed=6):
    b, t, h, kv, hd = 3, 256, 8, 2, 32
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    valid = np.zeros((b, t), np.int32)
    valid[0, :70] = 1
    valid[1, t - 40 :] = 1           # a wrapped ring
    valid[1, :30] = 1
    valid[2, :200] = 1
    return q, k, v, valid


def test_flash_decode_ops_match_jax():
    q, k, v, valid = _dense_decode_case()
    got = fd_ops.flash_decode_op(_t(q), _t(k), _t(v), _t(valid))
    want = jfd_ops.flash_decode_op(_j(q), _j(k), _j(v), jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = fd_ops.flash_decode_partials_op(_t(q), _t(k), _t(v), _t(valid))
    want = jfd_ops.flash_decode_partials_op(_j(q), _j(k), _j(v), jnp.asarray(valid))
    for a, b, tol in zip(got, want, (TOL2, TOL, TOL2)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def test_flash_decode_paged_op_matches_jax():
    b, nb, bs, h, kv, hd = 3, 4, 32, 4, 2, 16
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    perm = rng.permutation(b * nb + 1)[: b * nb]
    tables = perm.reshape(b, nb).astype(np.int32)
    pool_k = rng.standard_normal((b * nb + 1, bs, kv, hd)).astype(np.float32)
    pool_v = rng.standard_normal((b * nb + 1, bs, kv, hd)).astype(np.float32)
    ln = np.asarray([100, 1, 64], np.int32)
    got = fd_ops.flash_decode_paged_op(_t(q), _t(pool_k), _t(pool_v), _t(tables), _t(ln))
    want = jfd_ops.flash_decode_paged_op(_j(q), _j(pool_k), _j(pool_v),
                                         jnp.asarray(tables), jnp.asarray(ln))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "b,s,t,h,kv,hd,causal,window",
    [(2, 64, 64, 4, 2, 32, True, 0), (1, 128, 128, 4, 4, 64, True, 32),
     (1, 64, 64, 2, 1, 32, False, 0)],
)
def test_flash_attention_op_matches_jax(b, s, t, h, kv, hd, causal, window):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    got = fa_ops.flash_attention_op(_t(q), _t(k), _t(v), causal=causal, window=window)
    want = jfa_ops.flash_attention_op(_j(q), _j(k), _j(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL2)


# ---------------------------------------------------------------------------
# paged decode partials (test_paged_decode.py's cases)
# ---------------------------------------------------------------------------

def _paged_case(lengths, nb=4, bs=32, h=4, kv=2, hd=16, seed=9):
    """Identity-table pool of (b, nb*bs) logical slots with every dead page
    (block index >= ceil(len / bs)) poisoned with NaN."""
    b = len(lengths)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    pool_k = rng.standard_normal((b * nb, bs, kv, hd)).astype(np.float32)
    pool_v = rng.standard_normal((b * nb, bs, kv, hd)).astype(np.float32)
    tables = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    for bi, n in enumerate(lengths):
        live_pages = -(-n // bs)
        pool_k[bi * nb + live_pages : (bi + 1) * nb] = np.nan
        pool_v[bi * nb + live_pages : (bi + 1) * nb] = np.nan
    return q, pool_k, pool_v, tables, np.asarray(lengths, np.int32)


def _assert_empty_contract(acc, m, l, rows):
    """Requests with no live key: (acc, m, l) = (0, -1e30, 0) exactly."""
    assert (m[rows] == NEG_INF).all() and (l[rows] == 0).all() and (acc[rows] == 0).all()


def test_paged_partials_match_jax_and_dense_partials():
    q, pk, pv, tables, ln = _paged_case([100, 40, 0])
    live = ln > 0
    acc, m, l = flash_decode_paged(_t(q), _t(pk), _t(pv), _t(tables), _t(ln),
                                   return_partials=True)
    for x in (acc, m, l):
        assert x.dtype == torch.float32
    assert m.shape == l.shape == q.shape[:2]
    ja, jm, jl = jax.jit(lambda *a: jax_paged(*a, return_partials=True, interpret=True))(
        _j(q), _j(pk), _j(pv), jnp.asarray(tables), jnp.asarray(ln))
    np.testing.assert_allclose(m[live].numpy(), np.asarray(jm)[live], **TOL)
    np.testing.assert_allclose(l[live].numpy(), np.asarray(jl)[live], **TOL2)
    np.testing.assert_allclose(acc[live].numpy(), np.asarray(ja)[live], **TOL2)
    _assert_empty_contract(acc, m, l, ~live)
    # against the dense partials over the gathered logical view
    k = fd_ref.gather_pages(_t(np.nan_to_num(pk)), _t(tables))
    v = fd_ref.gather_pages(_t(np.nan_to_num(pv)), _t(tables))
    valid = torch.arange(k.shape[1])[None, :] < _t(ln)[:, None].long()
    for a, b in zip((acc, m, l), fd_ops.flash_decode_partials_op(_t(q), k, v, valid)):
        torch.testing.assert_close(a, b, **TOL2)


@pytest.mark.parametrize("n_slices", [2, 4])
def test_paged_partials_slices_merge_to_normalised(n_slices):
    """The block table cut into ``n_slices`` runs of NB / n_slices pages,
    lengths clipped per slice: the LSE merge of the slices' partials gives
    the normalised paged output (the port's and JAX's). Slices with live
    keys agree with JAX's partials; the others meet the empty contract."""
    nb, bs = 8, 32
    ln = np.asarray([200, 33, 64, 1], np.int32)
    q, pk, pv, tables, ln = _paged_case(ln, nb=nb, bs=bs)
    per = nb // n_slices
    parts = []
    for i in range(n_slices):
        tb = np.ascontiguousarray(tables[:, i * per : (i + 1) * per])
        li = np.clip(ln - i * per * bs, 0, per * bs).astype(np.int32)
        part = flash_decode_paged_partials(_t(q), _t(pk), _t(pv), _t(tb), _t(li))
        ja, jm, jl = jax_paged(_j(q), _j(pk), _j(pv), jnp.asarray(tb), jnp.asarray(li),
                               return_partials=True, interpret=True)
        live = li > 0
        for a, b, tol in zip(part, (ja, jm, jl), (TOL2, TOL, TOL2)):
            np.testing.assert_allclose(a[live].numpy(), np.asarray(b)[live], **tol)
        _assert_empty_contract(*part, ~live)
        parts.append(part)
    merged = fd_ref.merge_partials_local(parts)
    whole = flash_decode_paged(_t(q), _t(pk), _t(pv), _t(tables), _t(ln))
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), **TOL)
    want = jfd_ops.flash_decode_paged_op(_j(q), _j(pk), _j(pv), jnp.asarray(tables),
                                         jnp.asarray(ln))
    np.testing.assert_allclose(merged.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# CPU tensors take the plain versions
# ---------------------------------------------------------------------------

def test_cpu_tensors_launch_no_kernel():
    counters = (gmm_mod.gmm, gmm_mod.gmm_dual_act, ragged.gmm_gather,
                flash_decode_paged, flash_decode_paged_partials)
    before = [k.launches for k in counters]
    x = torch.randn(2, 8, 16)
    w = torch.randn(2, 16, 8)
    gmm_ops.expert_ffn(x, w, w, torch.randn(2, 8, 16))
    gmm_ops.gmm_gather_op(torch.randn(10, 16), w, torch.tensor([0, 4]),
                          torch.tensor([4, 6]), 8)
    q, pk, pv, tables, ln = _paged_case([40, 0])
    flash_decode_paged(_t(q), _t(pk), _t(pv), _t(tables), _t(ln), return_partials=True)
    assert [k.launches for k in counters] == before
