"""``gmm_fused_ffn``'s bf16 bodies on the CPU: their launch plan from static
shapes, and the order of operations the CUDA kernels rely on, held against
the Pallas kernel in interpret mode on the same seeded numpy inputs.

* Decode body (capacity <= 8): the hidden dimension in slices of
  ``fused_decode_slice`` columns, each slice's silu(x @ wg) * (x @ wu)
  rounded to the I/O dtype, its product with wd's rows summed as fp32
  partials in slice order, one rounding at the end.
* Prefill body (clusters): hidden blocks of 16 ranks x 64 columns, each
  rank's slice rounded on its own and the block assembled from the 16
  slices, the blocks' products accumulated in fp32 in block order, one
  rounding at the end.

The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.gmm.ragged import gmm_fused_ffn as pallas_fused
from repro_torch.kernels import tolerance
from repro_torch.kernels.gmm import ragged as K
from repro_torch.kernels.gmm import ref as R

torch.set_num_threads(1)
SMEM_PER_BLOCK = 232448   # an H100 block's opt-in dynamic shared memory (227 KB)
SMEM_PER_SM = 233472      # an H100 SM's (228 KB), 1 KB of it reserved per block


def test_fused_plan_from_static_shapes():
    """Which body a launch takes, the decode slice width and split count,
    the partials and counters the wrapper allocates (planned on meta
    tensors, which hold no counts), and the shared memory each bf16 body
    takes: two decode blocks an SM, one cluster CTA within the opt-in."""
    bf, f32 = torch.bfloat16, torch.float32
    assert [K.fused_body(c, dt) for c, dt in ((8, f32), (1024, f32), (8, bf), (1, bf), (9, bf),
                                               (1024, bf))] == [
        "fma", "fma", "decode", "decode", "cluster", "cluster"]
    for (g, f), fs in [((8, 16384), 512),     # mixtral's experts at the gate's widest
                       ((20, 10752), 512), ((8, 4096), 128), ((1, 16384), 128),
                       ((6, 96), 128), ((6, 1160), 128), ((64, 1024), 256)]:
        assert K.fused_decode_slice(g, f) == fs
    for g in (1, 2, 5, 8, 20, 64):
        for f in (8, 96, 1160, 4096, 16384, 32768):
            fs = K.fused_decode_slice(g, f)
            assert fs in K.FUSED_SLICES
            s = -(-f // fs)
            assert (s - 1) * fs < f                     # no empty slice
            if fs != K.FUSED_SLICES[-1]:                # widest that covers the card
                assert s * -(-g // 2) >= K.FUSED_SLICE_BLOCKS
    dec, clu = K.fused_smem_bytes("decode"), K.fused_smem_bytes("cluster")
    assert (dec, clu) == (111168, 230480)
    assert 2 * (dec + 1024) <= SMEM_PER_SM and clu <= SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        K.fused_smem_bytes("fma")

    meta = dict(device="meta")
    g, d, f, r = 8, 4096, 16384, 16
    wg = torch.empty((g, d, f), dtype=bf, **meta)
    wd = torch.empty((g, f, d), dtype=bf, **meta)
    off = torch.empty((g,), dtype=torch.int32, **meta)
    x = torch.empty((r, d), dtype=bf, **meta)
    out, part, arrived, ints = K._fused_plan(x, wg, wg, wd, off, off, 8, 1)
    assert tuple(out.shape) == (r, d) and ints == (g, 8, d, f, d, 1, r, 1, 512)
    assert part.numel() == 32 * g * 8 * d and arrived.numel() >= g * d // K.FUSED_OUT_STRIP
    x = torch.empty((4096, d), dtype=bf, **meta)
    out, part, arrived, ints = K._fused_plan(x, wg, wg, wd, off, off, 1024, 1)
    assert part is None and arrived is None and ints[-1] == 0
    x32 = torch.empty((r, 64), dtype=f32, **meta)
    w32 = torch.empty((g, 64, 96), dtype=f32, **meta)
    wd32 = torch.empty((g, 96, 64), dtype=f32, **meta)
    assert K._fused_plan(x32, w32, w32, wd32, off, off, 8, 1)[1:3] == (None, None)
    with pytest.raises(ValueError, match="positive"):
        K._fused_plan(torch.empty((r, 0), dtype=bf, **meta),
                      torch.empty((g, 0, 96), dtype=bf, **meta),
                      torch.empty((g, 0, 96), dtype=bf, **meta), wd32.to(bf), off, off, 8, 1)


def _sliced_ffn(x, wg, wu, wd, offsets, gs, cap, gpw, block, ranks):
    """The bf16 bodies' order of operations in plain torch: hidden blocks of
    ``block`` columns, each assembled from ``ranks`` slices whose hidden
    values are rounded to x.dtype on their own; the blocks' fp32 products
    with wd's rows summed in block order; one rounding at the end."""
    buckets = R.gather_buckets(x, offsets, gs, cap).float()
    f = wg.shape[-1]
    total = torch.zeros((buckets.shape[0], cap, wd.shape[-1]))
    for f0 in range(0, f, block):
        f1 = min(f0 + block, f)
        parts = []
        for s0 in range(f0, f1, block // ranks):
            s1 = min(s0 + block // ranks, f1)
            a = R._grouped_bmm(buckets, wg[..., s0:s1].float(), gpw)
            b = R._grouped_bmm(buckets, wu[..., s0:s1].float(), gpw)
            parts.append((F.silu(a) * b).to(x.dtype).float())
        total = total + R._grouped_bmm(torch.cat(parts, -1), wd[:, f0:f1].float(), gpw)
    live = torch.arange(cap)[None, :, None] < gs.clamp(max=cap)[:, None, None].long()
    y = torch.where(live, total, 0.0).to(x.dtype)
    return R.scatter_rows(y, offsets, gs, x.shape[0])


@pytest.mark.parametrize("body", ["decode", "cluster"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_slice_algebra_matches_pallas(body, dtype):
    """The slice (decode) and cluster (prefill) algebra against the Pallas
    kernel in interpret mode: 4 groups (gpw 2 at decode, 1 at prefill),
    one dead, one over the capacity, gap rows between segments (NaN on the
    torch side), D_out != D, hidden slices or blocks that do not divide F.
    fp32 to (1e-5, 1e-5): summation order only. bf16 to (2^-7, 2^-10)
    elementwise (``tolerance.excess``): both round the hidden values and the
    output once to bf16 from fp32 sums that differ in order, so an element
    may land one unit in the last place apart (at most 2^-7 of it)."""
    rng = np.random.default_rng(11 if body == "decode" else 12)
    g, d, f, d_out = 4, 128, (384 if body == "decode" else 1152), 96
    cap, gpw = (8, 2) if body == "decode" else (24, 1)
    counts = [cap - 3, 0, cap + 4, 1]
    offsets, pos = [], 0
    for c in counts:
        offsets.append(pos)
        pos += c + 2
    live = np.zeros(pos, bool)
    for o, c in zip(offsets, counts):
        live[o : o + min(c, cap)] = True
    x = rng.standard_normal((pos, d)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((g // gpw, d, f), (g // gpw, d, f), (g // gpw, f, d_out))]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(pallas_fused(
        jnp.asarray(x, jdt), *(jnp.asarray(w, jdt) for w in ws),
        jnp.asarray(offsets, jnp.int32), jnp.asarray(counts, jnp.int32), capacity=cap,
        groups_per_weight=gpw, interpret=True).astype(jnp.float32))
    xt = torch.tensor(x).to(dtype)
    xt[torch.tensor(~live)] = float("nan")
    wt = [torch.tensor(w).to(dtype) for w in ws]
    if body == "decode":
        block, ranks = K.fused_decode_slice(g, f), 1
        assert (block, -(-f // block)) == (128, 3)
    else:
        block, ranks = K.FUSED_RANKS * 64, K.FUSED_RANKS
        assert -(-f // block) == 2
    got = _sliced_ffn(xt, *wt, torch.tensor(offsets, dtype=torch.int32),
                      torch.tensor(counts, dtype=torch.int32), cap, gpw, block, ranks)
    got, want = got[torch.tensor(live)].float(), torch.tensor(want[live])
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    else:
        assert tolerance.excess(got, want, 2.0**-7, 2.0**-10) <= 1.0
