"""The port's CUDA kernels against their plain PyTorch versions, on the
card. This file imports no JAX (the machine with the card has none); every
test is marked ``cuda`` and skips without a device. Run on the card with:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The four-card mesh tests need four cards (NCCL across them) and skip
with fewer; the one-card mesh test runs on a 1 x 1 NCCL mesh.

Tolerances are elementwise, from :mod:`repro_torch.kernels.tolerance`:
``|kernel - plain| <= rtol |plain| + atol rms(row)``, with (1e-4, 1e-4) in
fp32 and (2^-5, 2^-5) in bf16; a bf16 GMM is also held to the fp32 product
of its own bf16 inputs at (2^-8, 2^-10), its output rounding alone.
"""

import dataclasses
from datetime import timedelta
from pathlib import Path

import pytest
import torch
import torch.multiprocessing as tmp

from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.flash_decode.flash_decode import flash_decode, flash_decode_partials
from repro_torch.kernels.flash_decode.paged import (
    CHUNK,
    MAX_SPLITS,
    can_flash_decode_paged,
    flash_decode_paged,
    flash_decode_paged_partials,
    split_count,
)
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.kernels.gmm.gmm import gmm, gmm_dual_act
from repro_torch.kernels.gmm.ragged import (
    gmm_dual_act_gather,
    gmm_dual_act_ragged,
    gmm_fused_ffn,
    gmm_gather,
    gmm_ragged,
    gmm_scatter,
)
from repro_torch.kernels.gmm.ragged import decode_splits
from repro_torch.kernels.tolerance import PLAIN, ROUNDING, excess

torch.set_num_threads(1)
DTYPES = [(torch.float32, PLAIN[torch.float32]), (torch.bfloat16, PLAIN[torch.bfloat16])]


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import); TF32 off so
    fp32 results compare as fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, dev, dtype, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _check(got, want, tol):
    torch.cuda.synchronize()
    assert excess(got, want, *tol) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("c", [8, 24])      # decode tile and prefill tile
def test_cuda_gmm_pair_matches_plain(cuda_device, dtype, tol, c):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    g, d, f = 6, 64, 96
    x = _rand(gen, cuda_device, dtype, g, c, d)
    gs = torch.tensor([0, c, 5, c - 1, 1, 3], dtype=torch.int32, device=cuda_device)
    dead = torch.arange(c, device=cuda_device)[None, :] >= gs[:, None]
    x[dead] = float("nan")
    wg = _rand(gen, cuda_device, dtype, g // 2, d, f, scale=0.1)
    wu = _rand(gen, cuda_device, dtype, g // 2, d, f, scale=0.1)
    h = gmm_dual_act_ragged(x, wg, wu, gs, 2)
    _check(h, gmm_ref.gmm_dual_act_ragged(x, wg, wu, gs, 2), tol)
    assert (h[dead] == 0).all()
    y = gmm_ragged(x, wg, gs, 2)
    _check(y, gmm_ref.gmm_ragged(x, wg, gs, 2), tol)
    assert (y[dead] == 0).all()
    if dtype == torch.bfloat16:   # the fp32 product of the same bf16 inputs
        x32, wg32, wu32 = x.float(), wg.float(), wu.float()
        _check(h, gmm_ref.gmm_dual_act_ragged(x32, wg32, wu32, gs, 2), ROUNDING)
        _check(y, gmm_ref.gmm_ragged(x32, wg32, gs, 2), ROUNDING)


def _paged_inputs(dev, dtype, lengths, *, g=4, kv=2, hd=64, bs=32, nb=4, seed=1):
    """Requests of ``lengths`` over ``nb`` scrambled pages of ``bs`` each
    (pool of nb B + 1 pages), ``g`` query heads per KV head: q, the pools,
    tables and lengths, every row past a request's length (dead rows of
    its last page and dead pages) NaN."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lengths)
    q = _rand(gen, dev, dtype, b, g * kv, hd)
    pk = _rand(gen, dev, dtype, b * nb + 1, bs, kv, hd)
    pv = _rand(gen, dev, dtype, b * nb + 1, bs, kv, hd)
    tables = torch.randperm(b * nb + 1, generator=gen, device=dev)[: b * nb]
    tables = tables.reshape(b, nb).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for i in range(b):
        for j in range(nb):
            lo = max(0, int(ln[i]) - j * bs)
            if lo < bs:
                pk[int(tables[i, j]), lo:] = float("nan")
                pv[int(tables[i, j]), lo:] = float("nan")
    return q, pk, pv, tables, ln


def _dense_inputs(dev, dtype, valid, *, g=6, kv=2, hd=64, seed=4):
    """q and a dense cache (B, T, kv, hd) for the int32 mask ``valid``
    (B, T), every invalid K/V row NaN."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, t = valid.shape
    q = _rand(gen, dev, dtype, b, g * kv, hd)
    k = _rand(gen, dev, dtype, b, t, kv, hd)
    v = _rand(gen, dev, dtype, b, t, kv, hd)
    k[valid == 0] = float("nan")
    v[valid == 0] = float("nan")
    return q, k, v, valid


def _prefix(dev, lengths, t):
    ln = torch.tensor(lengths, device=dev)
    return (torch.arange(t, device=dev)[None, :] < ln[:, None]).to(torch.int32)


# the four modes of the two decode kernels: (kernel, plain version)
DECODE_MODES = {
    "dense": (flash_decode, lambda q, k, v, m: fd_ref.decode(q, k, v, m.bool())),
    "dense_partials": (flash_decode_partials,
                       lambda q, k, v, m: fd_ref.decode_partials(q, k, v, m.bool())),
    "paged": (flash_decode_paged, fd_ref.paged_decode),
    "paged_partials": (flash_decode_paged_partials, fd_ref.paged_decode_partials),
}


def _hold_decode(mode, case, tol):
    """``mode`` on ``case`` (dense (q, k, v, valid) or paged (q, pk, pv,
    tables, lengths)) against its plain version: the output, or acc at the
    run's limit and m, l at the fp32 limit, a request with no live key
    exactly (0, -1e30, 0). Returns the kernel's output."""
    kernel, plain = DECODE_MODES[mode]
    got, want = kernel(*case), plain(*case)
    if mode.endswith("partials"):
        (acc, m, l), (acc_r, m_r, l_r) = got, want
        assert acc.dtype == m.dtype == l.dtype == torch.float32
        _check(acc, acc_r, tol)
        _check(m, m_r, PLAIN[torch.float32])
        _check(l, l_r, PLAIN[torch.float32])
        dead = l_r == 0
        assert (m[dead] == -1e30).all() and (l[dead] == 0).all() and (acc[dead] == 0).all()
    else:
        _check(got, want, tol)
    return got


def _decode_case(dev, dtype, mode, lengths, *, bs, nb, **kw):
    """Paged inputs of ``lengths``, or the dense cache of nb bs slots with
    each request's first ``lengths`` valid."""
    if mode.startswith("paged"):
        return _paged_inputs(dev, dtype, lengths, bs=bs, nb=nb, **kw)
    return _dense_inputs(dev, dtype, _prefix(dev, lengths, nb * bs), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("nb", [4, 20])     # 8 chunks, one a split; 40, two a split
@pytest.mark.parametrize("mode", list(DECODE_MODES))
def test_cuda_decode_split_edges(cuda_device, mode, nb, dtype, tol):
    """Lengths at the split edges: 0, 1, a chunk - 1, a chunk, a chunk + 1,
    two chunks + 1 (into the second split when a split takes two chunks)
    and the full cache (every slot valid), pages of 128; NaN past every
    length."""
    full = nb * 128
    lengths = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 1, full]
    assert split_count(full) == min(full // CHUNK, MAX_SPLITS)
    _hold_decode(mode, _decode_case(cuda_device, dtype, mode, lengths, bs=128, nb=nb, g=6),
                 tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("mode", ["dense", "dense_partials"])
def test_cuda_dense_decode_mask_holes(cuda_device, mode, dtype, tol):
    """Masks that are not prefixes, over a cache that is not a whole number
    of chunks: live chunks on both sides of a fully invalid one (with holes
    in them), a wrapped ring, one key at the start of the second chunk, a
    scattered half, and no valid key."""
    t = 4 * CHUNK + 17
    valid = torch.zeros((5, t), dtype=torch.int32, device=cuda_device)
    valid[0, :CHUNK] = 1
    valid[0, 5] = 0
    valid[0, 2 * CHUNK:3 * CHUNK:3] = 1
    valid[0, t - 1] = 1
    valid[1, t - 40:] = 1
    valid[1, :30] = 1
    valid[2, CHUNK] = 1
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    valid[3] = (torch.rand(t, generator=gen, device=cuda_device) < 0.5).to(torch.int32)
    _hold_decode(mode, _dense_inputs(cuda_device, dtype, valid), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 6, 16])
@pytest.mark.parametrize("mode", list(DECODE_MODES))
def test_cuda_decode_group_and_head_dim(cuda_device, mode, g, hd, dtype, tol):
    """Every GQA group and head dim the gates take, over pages of 64 (a
    chunk is one page) with NaN past every length."""
    assert can_flash_decode_paged(64, 2 * g, 2, hd, dtype)
    case = _decode_case(cuda_device, dtype, mode, [CHUNK + 1, 2, 3 * CHUNK], bs=64, nb=4,
                        g=g, hd=hd)
    _hold_decode(mode, case, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(DECODE_MODES))
def test_cuda_decode_calls_bitwise_equal(cuda_device, mode):
    """The split merge runs in split-index order with no atomics: two calls
    on the same inputs are bitwise equal."""
    case = _decode_case(cuda_device, torch.bfloat16, mode, [300, 0, 129, 64], bs=128, nb=4,
                        g=6, hd=128)
    first, second = DECODE_MODES[mode][0](*case), DECODE_MODES[mode][0](*case)
    torch.cuda.synchronize()
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (first, second))):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_paged_decode_matches_plain(cuda_device, dtype, tol):
    q, pk, pv, tables, ln = _paged_inputs(cuda_device, dtype, [100, 1, 64])
    _check(flash_decode_paged(q, pk, pv, tables, ln),
           fd_ref.paged_decode(q, pk, pv, tables, ln), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("hd,window,causal", [(64, 16, True), (128, 0, True), (32, 0, False)])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, tol, hd, window, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q = _rand(gen, cuda_device, dtype, 2, 40, 8, hd)
    k = _rand(gen, cuda_device, dtype, 2, 72, 2, hd)
    v = _rand(gen, cuda_device, dtype, 2, 72, 2, hd)
    _check(flash_attention(q, k, v, causal=causal, window=window),
           fa_ref.mha(q, k, v, causal=causal, window=window), tol)



@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s,t", [(200, 200), (40, 72)])
def test_cuda_flash_attention_noncausal_mha_hd64(cuda_device, dtype, tol, s, t):
    """The encoder's mode (seamless: non-causal, K = H, head dim 64), at
    query and key counts off the tiles."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = _rand(gen, cuda_device, dtype, 2, s, 16, 64)
    k = _rand(gen, cuda_device, dtype, 2, t, 16, 64)
    v = _rand(gen, cuda_device, dtype, 2, t, 16, 64)
    _check(flash_attention(q, k, v, causal=False), fa_ref.mha(q, k, v, causal=False), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("s,t,causal,window", [
    (40, 72, True, 16),       # S < T, a window
    (40, 72, False, 0),       # bidirectional
    (200, 200, True, 0),      # S not a multiple of the query tile of 64
    (130, 300, True, 64),     # three query tiles at the tail of the keys, a window
])
def test_cuda_flash_attention_bf16_wgmma(cuda_device, hd, s, t, causal, window):
    """The bf16 wgmma body over query-tile and key-tile edges."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    dt = torch.bfloat16
    q = _rand(gen, cuda_device, dt, 2, s, 6, hd)
    k = _rand(gen, cuda_device, dt, 2, t, 2, hd)
    v = _rand(gen, cuda_device, dt, 2, t, 2, hd)
    _check(flash_attention(q, k, v, causal=causal, window=window),
           fa_ref.mha(q, k, v, causal=causal, window=window), PLAIN[dt])

def _flat_layout(dev, counts, gap, cap):
    """Bucket segments with ``gap`` rows of dropped copies between them:
    offsets, the flat row count and the live-row mask."""
    offsets, pos = [], 0
    for c in counts:
        offsets.append(pos)
        pos += c + gap
    live = torch.zeros(pos, dtype=torch.bool, device=dev)
    for o, c in zip(offsets, counts):
        live[o : o + min(c, cap)] = True
    return torch.tensor(offsets, dtype=torch.int32, device=dev), pos, live


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("cap", [8, 24])     # decode body and prefill body
def test_cuda_gather_scatter_fused_match_plain(cuda_device, dtype, tol, cap):
    """Flat rows with NaN gap rows in, NaN-filled flat outputs: live rows
    within the limit, every other row still NaN (nothing spilled)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    counts = [0, cap, 5, cap + 3, 1, 3]       # one over capacity: its tail is a gap
    g, d, f = 6, 64, 96
    offsets, r, live = _flat_layout(cuda_device, counts, 2, cap)
    gs = torch.tensor([min(c, cap) for c in counts], dtype=torch.int32, device=cuda_device)
    x = _rand(gen, cuda_device, dtype, r, d)
    x[~live] = float("nan")
    wg = _rand(gen, cuda_device, dtype, g // 2, d, f, scale=0.1)
    wu = _rand(gen, cuda_device, dtype, g // 2, d, f, scale=0.1)
    wd = _rand(gen, cuda_device, dtype, g // 2, f, d, scale=0.1)
    h = gmm_dual_act_gather(x, wg, wu, offsets, gs, cap, 2)
    h_ref = gmm_ref.gmm_dual_act_gather(x, wg, wu, offsets, gs, cap, 2)
    _check(h, h_ref, tol)
    nan = lambda: torch.full((r, d), float("nan"), dtype=dtype, device=cuda_device)
    y = gmm_scatter(h_ref, wd, offsets, gs, r, 2, out=nan())
    y_ref = gmm_ref.gmm_scatter(h_ref, wd, offsets, gs, r, 2)
    _check(y[live], y_ref[live], tol)
    assert torch.isnan(y[~live]).all()
    fused = gmm_fused_ffn(x, wg, wu, wd, offsets, gs, cap, 2, out=nan())
    _check(fused[live], gmm_ref.gmm_fused_ffn(x, wg, wu, wd, offsets, gs, cap, 2)[live], tol)
    assert torch.isnan(fused[~live]).all()
    pair = gmm_scatter(h, wd, offsets, gs, r, 2)
    _check(fused[live], pair[live], tol)
    if dtype == torch.bfloat16:   # the fp32 product of the same bf16 inputs
        _check(h, gmm_ref.gmm_dual_act_gather(x.float(), wg.float(), wu.float(), offsets,
                                              gs, cap, 2), ROUNDING)
        _check(y[live], gmm_ref.gmm_scatter(h_ref.float(), wd.float(), offsets, gs, r,
                                            2)[live], ROUNDING)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("cap,gpw,d,f,d_out", [
    (8, 2, 64, 96, 64),          # decode body, one hidden slice wider than F
    (8, 1, 136, 1160, 200),      # decode, 10 slices of 128 (F tail of 8), D and D_out tails
    (24, 2, 64, 96, 64),         # prefill cluster, 8 ranks' slices over 96 hidden columns
    (72, 1, 200, 1096, 520),     # two row tiles, 3 hidden blocks (tail), D_out past one rank
    (40, 2, 64, 96, 4160),       # two output passes of 4096 columns
])
def test_cuda_fused_ffn_bodies(cuda_device, dtype, tol, cap, gpw, d, f, d_out):
    """gmm_fused_ffn's bodies (bf16: the hidden-slice decode body at
    capacity 8, the cluster body above; fp32: the FMA tiles) over flat rows
    with NaN gap rows, a count over the capacity, dead groups and shapes no
    tile divides, into NaN-filled outputs: live rows within the limit of the
    plain version and of the kernel pair, every other row still NaN, two
    calls bitwise equal; bf16 also at (2^-8, 2^-10) against the fp32
    products of the same inputs (the hidden tensor rounded to bf16 between
    them, as the kernel keeps it)."""
    gen = torch.Generator(device=cuda_device).manual_seed(21 + cap)
    counts = [0, cap, 5, cap + 3, 1, 3]
    g = len(counts)
    offsets, r, live = _flat_layout(cuda_device, counts, 2, cap)
    gs = torch.tensor(counts, dtype=torch.int32, device=cuda_device)   # one over capacity
    x = _rand(gen, cuda_device, dtype, r, d)
    x[~live] = float("nan")
    wg = _rand(gen, cuda_device, dtype, g // gpw, d, f, scale=0.1)
    wu = _rand(gen, cuda_device, dtype, g // gpw, d, f, scale=0.1)
    wd = _rand(gen, cuda_device, dtype, g // gpw, f, d_out, scale=0.1)
    nan = lambda: torch.full((r, d_out), float("nan"), dtype=dtype, device=cuda_device)
    y = gmm_fused_ffn(x, wg, wu, wd, offsets, gs, cap, gpw, out=nan())
    again = gmm_fused_ffn(x, wg, wu, wd, offsets, gs, cap, gpw, out=nan())
    torch.cuda.synchronize()
    assert torch.isnan(y[~live]).all() and torch.isnan(again[~live]).all()
    assert torch.equal(y[live], again[live])
    _check(y[live], gmm_ref.gmm_fused_ffn(x, wg, wu, wd, offsets, gs, cap, gpw)[live], tol)
    pair = gmm_scatter(gmm_dual_act_gather(x, wg, wu, offsets, gs, cap, gpw), wd, offsets,
                       gs, r, gpw)
    _check(y[live], pair[live], tol)
    if dtype == torch.bfloat16:
        h = gmm_ref.gmm_dual_act_gather(x.float(), wg.float(), wu.float(), offsets, gs, cap,
                                        gpw).to(dtype).float()
        want32 = gmm_ref.gmm_scatter(h, wd.float(), offsets, gs, r, gpw)
        _check(y[live], want32[live], ROUNDING)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("t", [200, 256])
def test_cuda_dense_decode_matches_plain(cuda_device, dtype, tol, t):
    """Prefix, wrapped-ring and empty validity rows, NaN in every invalid
    K/V row; any cache length."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q = _rand(gen, cuda_device, dtype, 3, 8, 64)
    k = _rand(gen, cuda_device, dtype, 3, t, 2, 64)
    v = _rand(gen, cuda_device, dtype, 3, t, 2, 64)
    valid = torch.zeros((3, t), dtype=torch.int32, device=cuda_device)
    valid[0, :150] = 1
    valid[1, t - 40 :] = 1
    valid[1, :30] = 1
    k[valid == 0] = float("nan")
    v[valid == 0] = float("nan")
    out = flash_decode(q, k, v, valid)
    _check(out, fd_ref.decode(q, k, v, valid.bool()), tol)
    assert (out[2] == 0).all()       # no valid key: zeros


def _partials_inputs(dev, dtype, t):
    """4 requests over a cache slice of ``t`` keys: a prefix, a wrapped
    ring, a single key and no valid key at all; NaN in every invalid K/V
    row."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = _rand(gen, dev, dtype, 4, 8, 64)
    k = _rand(gen, dev, dtype, 4, t, 2, 64)
    v = _rand(gen, dev, dtype, 4, t, 2, 64)
    valid = torch.zeros((4, t), dtype=torch.int32, device=dev)
    valid[0, :150] = 1
    valid[1, t - 40 :] = 1
    valid[1, :30] = 1
    valid[2, 77] = 1
    k[valid == 0] = float("nan")
    v[valid == 0] = float("nan")
    return q, k, v, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_decode_partials_match_plain(cuda_device, dtype, tol):
    """acc at the run's dtype limit, m and l at the fp32 limit (every
    rank's merge weight e^(m - m_max) depends on them); a slice with no
    valid key gives m = -1e30, l = 0, acc = 0 exactly."""
    q, k, v, valid = _partials_inputs(cuda_device, dtype, 256)
    acc, m, l = flash_decode_partials(q, k, v, valid)
    acc_r, m_r, l_r = fd_ref.decode_partials(q, k, v, valid.bool())
    for got, want in ((acc, acc_r), (m, m_r), (l, l_r)):
        assert got.dtype == torch.float32
    _check(acc[:3], acc_r[:3], tol)
    _check(m[:3], m_r[:3], PLAIN[torch.float32])
    _check(l[:3], l_r[:3], PLAIN[torch.float32])
    assert (m[3] == -1e30).all() and (l[3] == 0).all() and (acc[3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_partials_merge_matches_normalised_kernel(cuda_device, dtype, tol):
    """The LSE merge of the kernel's partials over 4 slices of the cache
    (one process) gives the normalised kernel's output over the whole
    cache; the request with no valid key gets zeros from both."""
    from repro_torch.kernels.flash_decode.ref import merge_partials_local

    q, k, v, valid = _partials_inputs(cuda_device, dtype, 256)
    parts = [flash_decode_partials(q, k[:, i:i + 64].contiguous(), v[:, i:i + 64].contiguous(),
                                   valid[:, i:i + 64].contiguous())
             for i in range(0, 256, 64)]
    merged = merge_partials_local(parts).to(dtype)
    want = flash_decode(q, k, v, valid)
    _check(merged, want, tol)
    assert (merged[3] == 0).all()


@pytest.mark.cuda
def test_cuda_decode_modes_count_apart(cuda_device):
    """The partials instantiation leaves the normalised mode's launches as
    they were: each mode counts its own."""
    q, k, v, valid = _partials_inputs(cuda_device, torch.bfloat16, 200)
    n0, p0 = flash_decode.launches, flash_decode_partials.launches
    flash_decode(q, k, v, valid)
    assert (flash_decode.launches, flash_decode_partials.launches) == (n0 + 1, p0)
    flash_decode(q, k, v, valid, return_partials=True)
    assert (flash_decode.launches, flash_decode_partials.launches) == (n0 + 1, p0 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("c", [8, 24])      # decode body and prefill body
def test_cuda_padded_gmm_matches_plain(cuda_device, dtype, tol, c):
    """gmm and gmm_dual_act with every row live (no counts), and the
    padded expert_ffn op over them."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    g, d, f = 4, 64, 96
    x = _rand(gen, cuda_device, dtype, g, c, d)
    wg = _rand(gen, cuda_device, dtype, g, d, f, scale=0.1)
    wu = _rand(gen, cuda_device, dtype, g, d, f, scale=0.1)
    wd = _rand(gen, cuda_device, dtype, g, f, d, scale=0.1)
    h = gmm_dual_act(x, wg, wu)
    _check(h, gmm_ref.gmm_dual_act(x, wg, wu), tol)
    y = gmm(x, wg)
    _check(y, gmm_ref.gmm(x, wg), tol)
    _check(gmm_ops.expert_ffn(x, wg, wu, wd), gmm_ref.expert_ffn(x, wg, wu, wd), tol)
    if dtype == torch.bfloat16:   # the fp32 product of the same bf16 inputs
        _check(h, gmm_ref.gmm_dual_act(x.float(), wg.float(), wu.float()), ROUNDING)
        _check(y, gmm_ref.gmm(x.float(), wg.float()), ROUNDING)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("cap", [8, 24])     # decode body and prefill body
@pytest.mark.parametrize("gap", [2, 0])      # gap rows; the last segment at R
def test_cuda_gmm_gather_matches_plain(cuda_device, dtype, tol, cap, gap):
    """Flat rows with NaN gap rows in, bucket-padded out with zero tails."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    counts = [0, cap, 5, cap + 3, 1, 3]
    g, d, f = 6, 64, 96
    offsets, r, live = _flat_layout(cuda_device, counts, gap, cap)
    gs = torch.tensor([min(c, cap) for c in counts], dtype=torch.int32, device=cuda_device)
    x = _rand(gen, cuda_device, dtype, r, d)
    x[~live] = float("nan")
    w = _rand(gen, cuda_device, dtype, g // 2, d, f, scale=0.1)
    y = gmm_gather(x, w, offsets, gs, cap, 2)
    _check(y, gmm_ref.gmm_gather(x, w, offsets, gs, cap, 2), tol)
    dead = torch.arange(cap, device=cuda_device)[None, :] >= gs[:, None]
    assert (y[dead] == 0).all()
    if dtype == torch.bfloat16:
        _check(y, gmm_ref.gmm_gather(x.float(), w.float(), offsets, gs, cap, 2), ROUNDING)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_paged_partials_match_plain(cuda_device, dtype, tol):
    """acc at the run's dtype limit, m and l at the fp32 limit; a request
    of length 0 gives (acc, m, l) = (0, -1e30, 0) exactly."""
    q, pk, pv, tables, ln = _paged_inputs(cuda_device, dtype, [100, 1, 64, 0])
    acc, m, l = flash_decode_paged(q, pk, pv, tables, ln, return_partials=True)
    acc_r, m_r, l_r = fd_ref.paged_decode_partials(q, pk, pv, tables, ln)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    _check(acc[:3], acc_r[:3], tol)
    _check(m[:3], m_r[:3], PLAIN[torch.float32])
    _check(l[:3], l_r[:3], PLAIN[torch.float32])
    assert (m[3] == -1e30).all() and (l[3] == 0).all() and (acc[3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_paged_partials_merge_matches_normalised_kernel(cuda_device, dtype, tol):
    """The block table cut into 4 slices of one page, lengths clipped per
    slice: the LSE merge of the kernel's partials gives the normalised
    paged kernel's output."""
    from repro_torch.kernels.flash_decode.ref import merge_partials_local

    q, pk, pv, tables, ln = _paged_inputs(cuda_device, dtype, [100, 1, 64, 128])
    parts = [flash_decode_paged_partials(q, pk, pv, tables[:, j:j + 1].contiguous(),
                                         (ln - 32 * j).clamp(0, 32).to(torch.int32))
             for j in range(4)]
    _check(merge_partials_local(parts).to(dtype), flash_decode_paged(q, pk, pv, tables, ln),
           tol)


@pytest.mark.cuda
def test_cuda_op_layer_kernels_count_apart(cuda_device):
    """The padded, gather and paged-partials launches count apart from the
    served kernels that share their sources."""
    counters = (gmm, gmm_dual_act, gmm_ragged, gmm_dual_act_ragged, gmm_gather,
                gmm_dual_act_gather, flash_decode_paged, flash_decode_paged_partials)
    before = [k.launches for k in counters]
    x = torch.randn((2, 8, 64), device=cuda_device)
    w = torch.randn((2, 64, 32), device=cuda_device)
    gmm_dual_act(x, w, w)
    gmm(x, w)
    gmm_gather(x.reshape(16, 64), w, torch.tensor([0, 8], dtype=torch.int32, device=cuda_device),
               torch.tensor([8, 3], dtype=torch.int32, device=cuda_device), 8)
    q, pk, pv, tables, ln = _paged_inputs(cuda_device, torch.float32, [40])
    flash_decode_paged(q, pk, pv, tables, ln, return_partials=True)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 0, 0, 1, 0, 0, 1]


MESH_SERVE = dict(max_seq=64, batch=4, slots_per_device=3, alpha=0.1)


def _small_cfg():
    from repro_torch.configs import get_config, smoke

    return dataclasses.replace(smoke(get_config("dbrx-132b")), head_dim=32)


# the paged EP Server with chunked admission through the scheduler, under a
# chaos plan with a death and a revival
CHUNK_SERVE = dict(max_seq=64, batch=4, slots_per_device=3, alpha=0.1, paged=True,
                   page_size=8, pool_pages=14, prefill_chunk=8)


def _small_esp_cfg():
    from repro_torch.configs import get_config, smoke

    return dataclasses.replace(smoke(get_config("mixtral-8x22b")), head_dim=32)


def _serve_cells(dev, n_devices: int, mesh=None) -> dict:
    """The small fp32 models on ``dev``, under ``mesh`` or (None) on one
    process with the slots on virtual EP over ``n_devices``: the chunked
    paged EP Server through the ``RequestScheduler`` under seed 5's chaos
    plan with a revival (streams, events, the placement table), and the
    ESP Server's greedy tokens on the dense cache (its window wrapped)."""
    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.scheduler import RequestScheduler
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = _small_cfg()
    extra = {"virtual_ep": n_devices} if mesh is None or mesh.model == 1 else {}
    srv = Server(cfg, ParallelCtx(mesh=mesh, capacity_factor=8.0),
                 T.init_params(cfg, seed=12, device=dev),
                 ServeConfig(**CHUNK_SERVE, **extra), device=dev)
    plan = FaultPlan.chaos(5, n_steps=12, n_devices=n_devices, pressure_pages=4,
                           nan_slots=(0,), revive=True)
    sched = RequestScheduler(srv, faults=plan)
    rng = np.random.default_rng(3)
    for i in range(6):
        sched.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 20))), 8,
                     arrival=i // 2)
    streams = sched.run()
    ecfg = _small_esp_cfg()
    esp = Server(ecfg, ParallelCtx(mesh=mesh, moe_impl="esp", capacity_factor=2.0),
                 T.init_params(ecfg, seed=10, device=dev),
                 ServeConfig(max_seq=64, batch=4, paged=False), device=dev)
    prompt = torch.randint(0, ecfg.vocab_size, (4, 12), generator=torch.Generator().manual_seed(9))
    return {"streams": {rid: t.tolist() for rid, t in streams.items()},
            "events": [(st, k) for st, k, _ in sched.events],
            "fired": sorted({d[0] for _, k, d in sched.events if k == "fault"}),
            "states": [r.state for r in sched.requests],
            "slot_of": srv.table.slot_of.tolist(),
            "esp": esp.generate(prompt.to(dev), 24).cpu()}


def _mesh_rank(rank, shape, init_file, prompt, out_dir):
    """One rank of a 4-card NCCL mesh serving the small fp32 models."""
    import torch.distributed as dist

    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.runtime.serve import ServeConfig, Server

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{init_file}", world_size=4,
                            rank=rank, timeout=timedelta(seconds=180), device_id=dev)
    mesh = make_mesh(*shape)
    cfg = _small_cfg()
    srv = Server(cfg, ParallelCtx(mesh=mesh, capacity_factor=8.0),
                 T.init_params(cfg, seed=12, device=dev), ServeConfig(**MESH_SERVE),
                 device=dev)
    flash_decode_partials.launches = 0
    tokens = srv.generate(prompt.to(dev), 12).cpu()
    partials = flash_decode_partials.launches
    cells = _serve_cells(dev, shape[1], mesh)
    torch.save({"tokens": tokens, "migrations": srv.migrations, "partials": partials,
                "cells": cells}, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_cuda_mesh_of_four_cards_matches_one_process(cuda_device, tmp_path, shape):
    """Four ranks over NCCL (EP all-to-all across cards, the partials
    kernel and the LSE merge, migration slices sent between cards): every
    rank's greedy tokens and migration count equal those of one process
    serving the same slots on virtual EP (capacity factor 8: no copy is
    dropped on either side). Then the paged cache (KV heads over the cards
    on 2 x 2; replicated on 1 x 4, where the 2 KV heads do not divide 4)
    with chunked admission through the scheduler under a chaos plan with a
    death and a revival (evacuation rows and the revival's slices sent
    between cards, the scrub on the card that holds the rows): streams,
    events and the placement table equal the one-process run's; and ESP
    (hidden-dim shards, the reduce-scatter): greedy tokens equal."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    cfg = _small_cfg()
    prompt = torch.randint(0, cfg.vocab_size, (4, 12),
                           generator=torch.Generator().manual_seed(11))
    ref = Server(cfg, ParallelCtx(moe_impl="ep", capacity_factor=8.0),
                 T.init_params(cfg, seed=12, device=cuda_device),
                 ServeConfig(virtual_ep=shape[1], **MESH_SERVE), device=cuda_device)
    want = ref.generate(prompt.to(cuda_device), 12).cpu()
    assert ref.migrations > 0
    tmp.spawn(_mesh_rank, args=(shape, str(tmp_path / "pg"), prompt, str(tmp_path)),
              nprocs=4, join=True)
    cells = _serve_cells(cuda_device, shape[1])
    assert {"device_death", "device_revival"} <= set(cells["fired"])
    assert set(cells["states"]) == {"FINISHED"}
    for rank in range(4):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert torch.equal(got["tokens"], want), rank
        assert got["migrations"] == ref.migrations
        assert got["partials"] == cfg.n_layers * 12
        for key in ("streams", "events", "fired", "states", "slot_of"):
            assert got["cells"][key] == cells[key], (rank, key)
        assert torch.equal(got["cells"]["esp"], cells["esp"]), rank


@pytest.mark.cuda
def test_cuda_mesh_of_one_card_serves_paged_chunked_faults_and_esp(cuda_device, tmp_path):
    """The same cells on a 1 x 1 NCCL mesh of this card (the slots on
    virtual EP over 4 devices, all on the one rank): the chunked paged EP
    Server through the scheduler under the chaos plan with a death and a
    revival, and the ESP Server, equal to the same models with no mesh;
    the mesh runs take ``flash_decode_paged`` on all KV heads, the chunk
    lane through ``ep_moe_shardmap``'s ``gmm_fused_ffn``, and ESP's ragged
    pair through ``esp_expert_ffn``."""
    import torch.distributed as dist

    from repro_torch.parallel.mesh import init_distributed, make_mesh

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    want = _serve_cells(cuda_device, 4)
    init_distributed(torch.device("cuda", 0), world_size=1, rank=0)
    try:
        before = {k: k.launches for k in (flash_decode_paged, gmm_fused_ffn,
                                           gmm_dual_act_ragged, gmm_ragged)}
        got = _serve_cells(cuda_device, 4, make_mesh(1, 1, timeout=timedelta(seconds=180)))
        torch.cuda.synchronize()
        launched = {k.__name__: k.launches - b for k, b in before.items()}
    finally:
        dist.destroy_process_group()
    assert {"device_death", "device_revival"} <= set(want["fired"])
    for key in ("streams", "events", "fired", "states", "slot_of"):
        assert got[key] == want[key], key
    assert torch.equal(got["esp"], want["esp"])
    assert all(launched.values()), launched


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["padded", "every_row", "gather", "scatter"])
@pytest.mark.parametrize("d,f,c", [
    (200, 96, 24),    # a K tail (D % 64 != 0), an F tail below one tile, C < 128
    (200, 96, 130),   # C past one row tile
    (64, 320, 130),   # a partial last column tile
])
def test_cuda_gmm_bf16_prefill_wgmma(cuda_device, layout, d, f, c):
    """The bf16 prefill (wgmma) body in each row layout, against the plain
    version and the fp32 product of the same inputs: dead and gap rows NaN,
    two groups per weight where the layout has counts, and a NaN-filled
    scatter output whose rows outside the live segments stay NaN."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    dt, tol = torch.bfloat16, PLAIN[torch.bfloat16]
    g = 6
    counts = [0, c, 5, c - 1, 1, min(c, 3)]
    gpw = 1 if layout == "every_row" else 2
    wg = _rand(gen, cuda_device, dt, g // gpw, d, f, scale=0.1)
    wu = _rand(gen, cuda_device, dt, g // gpw, d, f, scale=0.1)
    gs = torch.tensor(counts, dtype=torch.int32, device=cuda_device)
    if layout == "every_row":
        x = _rand(gen, cuda_device, dt, g, c, d)
        got = [gmm_dual_act(x, wg, wu), gmm(x, wg)]
        want = [gmm_ref.gmm_dual_act(x, wg, wu), gmm_ref.gmm(x, wg)]
        want32 = [gmm_ref.gmm_dual_act(x.float(), wg.float(), wu.float()),
                  gmm_ref.gmm(x.float(), wg.float())]
    elif layout == "padded" or layout == "scatter":
        x = _rand(gen, cuda_device, dt, g, c, d)
        dead = torch.arange(c, device=cuda_device)[None, :] >= gs[:, None]
        x[dead] = float("nan")
        if layout == "padded":
            got = [gmm_dual_act_ragged(x, wg, wu, gs, gpw), gmm_ragged(x, wg, gs, gpw)]
            want = [gmm_ref.gmm_dual_act_ragged(x, wg, wu, gs, gpw),
                    gmm_ref.gmm_ragged(x, wg, gs, gpw)]
            want32 = [gmm_ref.gmm_dual_act_ragged(x.float(), wg.float(), wu.float(), gs, gpw),
                      gmm_ref.gmm_ragged(x.float(), wg.float(), gs, gpw)]
            for y in got:
                assert (y[dead] == 0).all()
        else:
            offsets, r, live = _flat_layout(cuda_device, counts, 3, c)
            y = gmm_scatter(x, wg, offsets, gs, r, gpw,
                            out=torch.full((r, f), float("nan"), dtype=dt, device=cuda_device))
            torch.cuda.synchronize()
            assert torch.isnan(y[~live]).all()
            got = [y[live]]
            want = [gmm_ref.gmm_scatter(x, wg, offsets, gs, r, gpw)[live]]
            want32 = [gmm_ref.gmm_scatter(x.float(), wg.float(), offsets, gs, r, gpw)[live]]
    else:
        offsets, r, live = _flat_layout(cuda_device, counts, 3, c)
        x = _rand(gen, cuda_device, dt, r, d)
        x[~live] = float("nan")
        got = [gmm_dual_act_gather(x, wg, wu, offsets, gs, c, gpw),
               gmm_gather(x, wg, offsets, gs, c, gpw)]
        want = [gmm_ref.gmm_dual_act_gather(x, wg, wu, offsets, gs, c, gpw),
                gmm_ref.gmm_gather(x, wg, offsets, gs, c, gpw)]
        want32 = [gmm_ref.gmm_dual_act_gather(x.float(), wg.float(), wu.float(), offsets, gs,
                                              c, gpw),
                  gmm_ref.gmm_gather(x.float(), wg.float(), offsets, gs, c, gpw)]
    for y, w, w32 in zip(got, want, want32):
        _check(y, w, tol)
        _check(y, w32, ROUNDING)


@pytest.mark.cuda
@pytest.mark.parametrize("dual", [True, False])
def test_cuda_gmm_bf16_prefill_gather_no_rows(cuda_device, dual):
    """A flat input of no rows at a prefill capacity: every group is empty,
    the padded output all zeros (no load is issued)."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    dt, g, d, f, cap = torch.bfloat16, 4, 64, 96, 24
    x = torch.empty((0, d), dtype=dt, device=cuda_device)
    w = _rand(gen, cuda_device, dt, g, d, f, scale=0.1)
    zeros = torch.zeros(g, dtype=torch.int32, device=cuda_device)
    y = (gmm_dual_act_gather(x, w, w, zeros, zeros, cap) if dual
         else gmm_gather(x, w, zeros, zeros, cap))
    torch.cuda.synchronize()
    assert y.shape == (g, cap, f) and (y == 0).all()


# (D, F, S): a K tail and one column strip (S = 1); two K splits of 9
# stages with an F tail in the second bf16 strip; three splits, the last
# one stage shorter
DECODE_SHAPES = [(200, 96, 1), (1096, 200, 2), (1608, 96, 3)]


def _decode_forms(dev, dt, layout, c, d, f, gpw, gen):
    """Each product the layout has at decode capacity ``c``: (name, the
    kernel call, the plain version of the inputs, the inputs, the live-row
    mask of a flat output or None)."""
    g = 6
    counts = [0, c, 1, c, min(2, c), 0]        # counts 0, 1 and C; dead groups
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    wg = _rand(gen, dev, dt, g // gpw, d, f, scale=0.1)
    wu = _rand(gen, dev, dt, g // gpw, d, f, scale=0.1)
    if layout == "every_row":
        x = _rand(gen, dev, dt, g, c, d)
        return [
            ("gmm_dual_act", lambda: gmm_dual_act(x, wg, wu),
             lambda a, b, u: gmm_ref.gmm_dual_act(a, b, u), (x, wg, wu), None),
            ("gmm", lambda: gmm(x, wg), lambda a, b: gmm_ref.gmm(a, b), (x, wg), None),
        ]
    if layout in ("padded", "scatter"):
        x = _rand(gen, dev, dt, g, c, d)
        x[torch.arange(c, device=dev)[None, :] >= gs[:, None]] = float("nan")
        if layout == "padded":
            return [
                ("gmm_dual_act_ragged", lambda: gmm_dual_act_ragged(x, wg, wu, gs, gpw),
                 lambda a, b, u: gmm_ref.gmm_dual_act_ragged(a, b, u, gs, gpw), (x, wg, wu),
                 None),
                ("gmm_ragged", lambda: gmm_ragged(x, wg, gs, gpw),
                 lambda a, b: gmm_ref.gmm_ragged(a, b, gs, gpw), (x, wg), None),
            ]
        offsets, r, live = _flat_layout(dev, counts, 3, c)
        nan = lambda: torch.full((r, f), float("nan"), dtype=dt, device=dev)
        return [
            ("gmm_scatter", lambda: gmm_scatter(x, wg, offsets, gs, r, gpw, out=nan()),
             lambda a, b: gmm_ref.gmm_scatter(a, b, offsets, gs, r, gpw), (x, wg), live),
        ]
    offsets, r, live = _flat_layout(dev, counts, 3, c)
    x = _rand(gen, dev, dt, r, d)
    x[~live] = float("nan")
    return [
        ("gmm_dual_act_gather", lambda: gmm_dual_act_gather(x, wg, wu, offsets, gs, c, gpw),
         lambda a, b, u: gmm_ref.gmm_dual_act_gather(a, b, u, offsets, gs, c, gpw),
         (x, wg, wu), None),
        ("gmm_gather", lambda: gmm_gather(x, wg, offsets, gs, c, gpw),
         lambda a, b: gmm_ref.gmm_gather(a, b, offsets, gs, c, gpw), (x, wg), None),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("d,f,splits", DECODE_SHAPES)
@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("layout,gpw", [
    ("padded", 1), ("padded", 2), ("every_row", 1), ("gather", 1), ("gather", 2),
    ("scatter", 1), ("scatter", 2),
])
def test_cuda_gmm_decode_body(cuda_device, layout, gpw, c, d, f, splits, dtype, tol):
    """The decode body (C <= 8) in each row layout and product against the
    plain version, bf16 also against the fp32 product of the same inputs:
    counts 0, 1 and C, dead groups, dead and gap rows NaN, a NaN-filled
    scatter output whose rows outside the live segments stay NaN, one to
    three K splits; two calls bitwise equal."""
    assert decode_splits(6, d, f, dtype, layout == "every_row") == splits
    gen = torch.Generator(device=cuda_device).manual_seed(15 + c)
    for name, call, plain, args, live in _decode_forms(cuda_device, dtype, layout, c, d, f,
                                                       gpw, gen):
        y, again = call(), call()
        want = plain(*args)
        torch.cuda.synchronize()
        if live is not None:
            assert torch.isnan(y[~live]).all() and torch.isnan(again[~live]).all(), name
            y, again, want = y[live], again[live], want[live]
        assert torch.equal(y, again), name
        _check(y, want, tol)
        if dtype == torch.bfloat16:   # the fp32 product of the same bf16 inputs
            want32 = plain(*(t.float() for t in args))
            _check(y, want32 if live is None else want32[live], ROUNDING)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dual", [True, False])
def test_cuda_gmm_decode_gather_no_rows(cuda_device, dual, dtype):
    """A flat input of no rows at a decode capacity: every group is empty,
    the padded output all zeros (no load is issued)."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    g, d, f, cap = 4, 1096, 96, 8
    x = torch.empty((0, d), dtype=dtype, device=cuda_device)
    w = _rand(gen, cuda_device, dtype, g, d, f, scale=0.1)
    zeros = torch.zeros(g, dtype=torch.int32, device=cuda_device)
    y = (gmm_dual_act_gather(x, w, w, zeros, zeros, cap) if dual
         else gmm_gather(x, w, zeros, zeros, cap))
    torch.cuda.synchronize()
    assert y.shape == (g, cap, f) and (y == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 14])
def test_cuda_scheduler_chaos_small_model(cuda_device, seed):
    """``chip_smoke.small_chaos_parity`` on the card: a small fp32 MoE under
    the chaos plan (death, revival with blank rows, straggler, pool
    pressure, NaN) through the ``RequestScheduler``, with the kernels and on
    the plain path. Every stream, recomputed ones included, equals the
    fault-free run's; the runs agree event for event; no decode tick routes
    to the dead device before its first re-committed replica; the kernel
    run's launches equal the prediction."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    held = chip_smoke.small_chaos_parity(torch, seed)
    assert held["n_preempted"] > 0 and held["launches"]["flash_attention"] > 0


@pytest.mark.cuda
def test_cuda_chunked_admission_and_restore_small_model(cuda_device):
    """``chip_smoke.small_chunk_parity`` on the card: a small fp32 MoE
    served with chunked admission, with the kernels and on the plain path,
    gives every stream of splice admission with launches as predicted (no
    ``flash_attention``); a crash with a request mid-prefill, restored from
    the snapshot file on a fresh server, serves every stream of the
    uninterrupted run."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    held = chip_smoke.small_chunk_parity(torch)
    assert held["mid_prefill"] and held["launches"]["flash_attention"] == 0
    assert held["launches"]["gmm_ragged"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-72b", "tinyllama-1.1b", "deepseek-7b", "zamba2-1.2b",
                                  "xlstm-350m", "seamless-m4t-medium", "internvl2-76b"])
def test_cuda_family_small_model(cuda_device, arch):
    """``chip_smoke.small_family_parity`` on the card: the family's smoke()
    model at head dim 32, fp32, ``Server.generate`` with the kernels equal
    to the plain path (stub embeds for internvl2 and seamless, internvl2
    paged), launches as the layer count predicts."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    launched = chip_smoke.small_family_parity(torch, arch)
    assert bool(launched) == (arch != "xlstm-350m")


# ---------------------------------------------------------------------------
# autograd through the registry (training): kernel forward, plain backward
# ---------------------------------------------------------------------------

def _registry_case(dev, dtype, form, gen):
    """(inputs, registry call, plain call, live rows of the output or None)
    of one registry form at small shapes the kernels take."""
    from repro_torch.kernels import registry as R
    from repro_torch.models.attention import chunked_gqa_attend

    if form == "attend":
        q = _rand(gen, dev, dtype, 2, 64, 4, 32)
        k, v = (_rand(gen, dev, dtype, 2, 64, 2, 32) for _ in range(2))
        return ((q, k, v), lambda *a: R.attend(*a, causal=True, window=16),
                lambda *a: chunked_gqa_attend(*a, True, 16), None)
    g, d, f = 6, 64, 96
    ws = (_rand(gen, dev, dtype, g // 2, d, f, scale=0.1),
          _rand(gen, dev, dtype, g // 2, d, f, scale=0.1),
          _rand(gen, dev, dtype, g // 2, f, d, scale=0.1))
    if form == "ragged":
        x = _rand(gen, dev, dtype, g, 24, d)
        gs = torch.tensor([0, 24, 5, 17, 1, 3], dtype=torch.int32, device=dev)
        return ((x, *ws), lambda *a: R.expert_ffn(*a, gs, 2),
                lambda *a: gmm_ref.expert_ffn_ragged(*a, gs, 2), None)
    cap = 24
    counts = [0, cap, 5, cap + 3, 1, 3]
    offsets, r, live = _flat_layout(dev, counts, 2, cap)
    gs = torch.tensor([min(c, cap) for c in counts], dtype=torch.int32, device=dev)
    x = _rand(gen, dev, dtype, r, d)
    kw = dict(capacity=cap, groups_per_weight=2, compact_out=form != "gather",
              fused=form == "fused")
    plain = {"gather": lambda *a: gmm_ref.gmm_ragged(
                 gmm_ref.gmm_dual_act_gather(*a[:3], offsets, gs, cap, 2), a[3], gs, 2),
             "compact": lambda *a: gmm_ref.expert_ffn_compact(*a, offsets, gs, cap, 2),
             "fused": lambda *a: gmm_ref.gmm_fused_ffn(*a, offsets, gs, cap, 2)}[form]
    return ((x, *ws), lambda *a: R.expert_ffn_from_rows(*a, offsets, gs, **kw), plain,
            None if form == "gather" else live)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("form", ["ragged", "gather", "compact", "fused", "attend"])
def test_cuda_registry_grads_match_plain(cuda_device, dtype, tol, form):
    """Each registry entry on CUDA tensors that require grad returns an
    output with a ``grad_fn`` (the CUDA kernel forward, one launch), and
    its output and its gradients for every float input equal those of the
    plain path's autograd within the run's limit; the backward launches no
    kernel. The plain path of attention is the online-softmax
    ``chunked_gqa_attend`` (the plain attention beyond
    ``CHUNKED_KV_THRESHOLD`` and the reference's backward rule): in bf16
    its gradients part from the masked softmax's by about the bf16 limit
    (a bf16 accumulator and normaliser), so they are held to the rule the
    Function declares."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    inputs, kernel, plain, live = _registry_case(cuda_device, dtype, form, gen)
    rows = slice(None) if live is None else live
    kern = {"attend": fa, "ragged": gmm_ragged, "gather": gmm_dual_act_gather,
            "compact": gmm_scatter, "fused": gmm_fused_ffn}[form]
    tin = [t.clone().requires_grad_() for t in inputs]
    before = kern.launches
    out = kernel(*tin)
    assert out.grad_fn is not None, form
    assert kern.launches == before + 1
    ct = torch.randn(out.shape, generator=gen, device=cuda_device).to(dtype)
    if live is not None:
        ct[~live] = 0
    grads = torch.autograd.grad(out, tin, ct)
    assert kern.launches == before + 1           # the backward is plain
    pin = [t.clone().requires_grad_() for t in inputs]
    want = plain(*pin)
    want_grads = torch.autograd.grad(want, pin, ct)
    _check(out[rows], want[rows], tol)
    for got, w in zip(grads, want_grads):
        _check(got, w, tol)


@pytest.mark.cuda
def test_cuda_no_registry_output_loses_its_graph(cuda_device):
    """Every differentiable registry entry, on CUDA tensors that require
    grad, in fp32 and bf16, returns an output with a ``grad_fn``: no
    gradient through a kernel on the card is silently dropped."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    for dtype in (torch.float32, torch.bfloat16):
        for form in ("ragged", "gather", "compact", "fused", "attend"):
            inputs, kernel, _, _ = _registry_case(cuda_device, dtype, form, gen)
            for i in range(len(inputs)):
                tin = [t.clone().requires_grad_(j == i) for j, t in enumerate(inputs)]
                assert kernel(*tin).grad_fn is not None, (form, dtype, i)
