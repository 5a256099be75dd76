"""The port's CUDA kernels against their plain PyTorch versions, on the
card. This file imports no JAX (the machine with the card has none); every
test is marked ``cuda`` and skips without a device. Run on the card with:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are elementwise, from :mod:`repro_torch.kernels.tolerance`:
``|kernel - plain| <= rtol |plain| + atol rms(row)``, with (1e-4, 1e-4) in
fp32 and (2^-5, 2^-5) in bf16; a bf16 GMM is also held to the fp32 product
of its own bf16 inputs at (2^-8, 2^-10), its output rounding alone.
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.flash_decode.flash_decode import flash_decode
from repro_torch.kernels.flash_decode.paged import flash_decode_paged
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.kernels.gmm.ragged import (
    gmm_dual_act_gather,
    gmm_dual_act_ragged,
    gmm_fused_ffn,
    gmm_ragged,
    gmm_scatter,
)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_paged_decode_matches_plain(cuda_device, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = _rand(gen, cuda_device, dtype, 3, 8, 64)
    pk = _rand(gen, cuda_device, dtype, 13, 32, 2, 64)
    pv = _rand(gen, cuda_device, dtype, 13, 32, 2, 64)
    tables = torch.randperm(13, generator=gen, device=cuda_device)[:12]
    tables = tables.reshape(3, 4).to(torch.int32).contiguous()
    ln = torch.tensor([100, 1, 64], dtype=torch.int32, device=cuda_device)
    for b in range(3):
        for j in range(4):
            lo = max(0, int(ln[b]) - j * 32)
            if lo < 32:
                pk[int(tables[b, j]), lo:] = float("nan")
                pv[int(tables[b, j]), lo:] = float("nan")
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
