"""The partials mode of the dense flash decode (``flash_decode(...,
return_partials=True)``) and its LSE merge, against the JAX package: the
plain ``decode_partials`` against the Pallas kernel in interpret mode, and
the merge of four slices (in one process, and through the all-reduce
merge ``collectives.merge_partials`` over a gloo world of one) against
JAX's merge and the normalised decode. fp32 on the CPU. The CUDA kernel runs on the card
(``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.kernels.flash_decode.flash_decode import flash_decode as pallas_decode
from repro.kernels.flash_decode.flash_decode import merge_partials as jax_merge
from repro.kernels.flash_decode.paged import flash_decode_paged as pallas_paged
from repro.kernels.flash_decode.ref import decode_ref
from repro_torch.kernels import registry
from repro_torch.kernels.flash_decode import ref
from repro_torch.kernels.flash_decode.flash_decode import flash_decode
from repro_torch.kernels.flash_decode.paged import CHUNK
from repro_torch.parallel.collectives import merge_partials

torch.set_num_threads(1)
# partials over one slice: fp32 summation order only
TOL = dict(rtol=1e-5, atol=1e-5)
# a merged output: the bound of the reference's own sequence-parallel test
MERGE_ATOL = 2e-5
B, H, KV, HD, T = 3, 8, 2, 16, 64


def _inputs(seed):
    """q, k, v and a validity with a live prefix in slice 0 only for
    request 0, a wrapped ring for request 1 and one scattered key for
    request 2, so that each of the four 16-key slices below has requests
    with no valid key."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, HD)).astype(np.float32)
    valid = np.zeros((B, T), np.int32)
    valid[0, :11] = 1
    valid[1, T - 5 :] = valid[1, :3] = 1
    valid[2, 37] = 1
    return q, k, v, valid


def _slices(*arrays, n=4):
    step = T // n
    return [[a[:, i * step : (i + 1) * step] for a in arrays] for i in range(n)]


@pytest.fixture
def gloo_world(tmp_path):
    """A gloo process group of one rank in this process, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_decode_partials_match_pallas_on_live_slices():
    """``(acc, m, l)`` of every (slice, request) with a valid key equal the
    Pallas kernel's in interpret mode, ``m`` included (every rank's merge
    weight depends on it)."""
    q, k, v, valid = _inputs(0)
    checked = 0
    for ks, vs, ms in _slices(k, v, valid):
        j_acc, j_m, j_l = (np.asarray(a) for a in pallas_decode(
            jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(ms),
            return_partials=True, interpret=True))
        acc, m, l = (a.numpy() for a in flash_decode(
            torch.tensor(q), torch.tensor(ks), torch.tensor(vs), torch.tensor(ms),
            return_partials=True))
        assert acc.dtype == m.dtype == l.dtype == np.float32
        live = ms.any(axis=1)
        np.testing.assert_allclose(acc[live], j_acc[live], **TOL)
        np.testing.assert_allclose(m[live], j_m[live], **TOL)
        np.testing.assert_allclose(l[live], j_l[live], **TOL)
        checked += int(live.sum())
    assert checked >= 4


def test_decode_partials_masked_slice_contract():
    """A slice with no valid key (NaN in its K/V rows) gives ``m = -1e30``,
    ``l = 0``, ``acc = 0``, where the Pallas kernel gives ``m = -1e30`` with
    non-zero ``l`` (p = 1 per masked key)."""
    q, k, v, valid = _inputs(1)
    ks, vs, ms = k[:, 16:32].copy(), v[:, 16:32].copy(), valid[:, 16:32]
    assert not ms[0].any()
    ks[ms == 0] = np.nan
    vs[ms == 0] = np.nan
    acc, m, l = flash_decode(torch.tensor(q), torch.tensor(ks), torch.tensor(vs),
                             torch.tensor(ms), return_partials=True)
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    _, j_m, j_l = pallas_decode(jnp.asarray(q), jnp.asarray(k[:, 16:32]),
                                jnp.asarray(v[:, 16:32]), jnp.asarray(ms),
                                return_partials=True, interpret=True)
    assert (np.asarray(j_m)[0] == -1e30).all() and (np.asarray(j_l)[0] > 0).all()


def test_merge_of_four_slices_matches_jax_and_normalised(gloo_world):
    """Four slices merged in one process (``merge_partials_local``), and the
    whole cache's partials through the all-reduce merge over a world of
    one, both equal JAX's merge of its own four slices and the
    normalised decode."""
    q, k, v, valid = _inputs(2)
    want = np.asarray(decode_ref(*(jnp.asarray(a) for a in (q, k, v, valid))))
    parts = [flash_decode(*(torch.tensor(a) for a in (q, ks, vs, ms)), return_partials=True)
             for ks, vs, ms in _slices(k, v, valid)]
    local = ref.merge_partials_local(parts).numpy()
    j_parts = [pallas_decode(*(jnp.asarray(a) for a in (q, ks, vs, ms)),
                             return_partials=True, interpret=True)
               for ks, vs, ms in _slices(k, v, valid)]
    stacked = [jnp.stack([p[i] for p in j_parts]) for i in range(3)]
    j_merged = np.asarray(jax.vmap(lambda a, m, l: jax_merge(a, m, l, "i"),
                                   axis_name="i")(*stacked)[0])
    acc, m, l = registry.decode_attend_partials(*(torch.tensor(a) for a in (q, k, v, valid)))
    world = merge_partials(acc, m, l, gloo_world, torch.float32).numpy()
    for got in (local, world):
        np.testing.assert_allclose(got, j_merged, rtol=0, atol=MERGE_ATOL)
        np.testing.assert_allclose(got, want, rtol=0, atol=MERGE_ATOL)
    normalised = flash_decode(*(torch.tensor(a) for a in (q, k, v, valid))).numpy()
    np.testing.assert_allclose(local, normalised, rtol=0, atol=MERGE_ATOL)


def test_merge_of_masked_slices_gives_zeros():
    """A request whose every slice is masked merges to zeros (the port's
    normalised decode gives zeros there too)."""
    q, k, v, valid = _inputs(3)
    valid[2] = 0
    parts = [flash_decode(*(torch.tensor(a) for a in (q, ks, vs, ms)), return_partials=True)
             for ks, vs, ms in _slices(k, v, valid)]
    merged = ref.merge_partials_local(parts)
    assert (merged[2] == 0).all()
    assert (flash_decode(*(torch.tensor(a) for a in (q, k, v, valid)))[2] == 0).all()


def _lse_partials(parts):
    """The split kernels' partials-mode merge: (acc, m, l) at the common
    max of the slices' partials."""
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    w = [torch.exp(p[1] - m) for p in parts]
    return (sum(p[0] * wi[..., None] for p, wi in zip(parts, w)), m,
            sum(p[2] * wi for p, wi in zip(parts, w)))


def test_chunk_partials_merge_to_the_pallas_kernels():
    """The algebra the split kernels rest on, at their chunk of CHUNK = 64
    keys: the plain partials over chunk-sized slices, LSE-merged, equal the
    JAX kernels in interpret mode (the normalised output, and the whole
    cache's partials at the common max), fp32 within ``MERGE_ATOL``.

    Dense (256 slots, 4 chunks): live chunks on both sides of a fully
    masked one, a wrapped ring, one key at the start of the second chunk.
    Paged (pages of 128, so each chunk is half a page and a chunk boundary
    falls inside every page): lengths 200, 0 and 65; a chunk is read
    through the pool viewed as pages of 64 (page p's half h is page
    2p + h), as the kernel's rows are addressed."""
    rng = np.random.default_rng(7)
    b, h, kv, hd, t = 3, 8, 2, 16, 4 * CHUNK
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    valid = np.zeros((b, t), np.int32)
    valid[0, :CHUNK:3] = 1
    valid[0, 2 * CHUNK + 5:3 * CHUNK + 9] = 1       # chunk 1 fully masked
    valid[1, t - 5:] = valid[1, :3] = 1
    valid[2, CHUNK] = 1
    assert not valid[0, CHUNK:2 * CHUNK].any()
    parts = [ref.decode_partials(torch.tensor(q), torch.tensor(k[:, i:i + CHUNK]),
                                 torch.tensor(v[:, i:i + CHUNK]),
                                 torch.tensor(valid[:, i:i + CHUNK]).bool())
             for i in range(0, t, CHUNK)]
    args = [jnp.asarray(a) for a in (q, k, v, valid)]
    want = np.asarray(pallas_decode(*args, interpret=True))
    np.testing.assert_allclose(ref.merge_partials_local(parts).numpy(), want, rtol=0,
                               atol=MERGE_ATOL)
    j_parts = pallas_decode(*args, return_partials=True, interpret=True)
    for got, w in zip(_lse_partials(parts), j_parts):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=MERGE_ATOL)

    bs, nb = 128, 2
    pool_k = rng.standard_normal((b * nb + 1, bs, kv, hd)).astype(np.float32)
    pool_v = rng.standard_normal((b * nb + 1, bs, kv, hd)).astype(np.float32)
    tables = rng.permutation(b * nb + 1)[: b * nb].reshape(b, nb).astype(np.int32)
    lengths = np.array([200, 0, 65], np.int32)
    half = bs // CHUNK
    pk, pv = (torch.tensor(p).reshape(-1, CHUNK, kv, hd) for p in (pool_k, pool_v))
    chunk_tables = (torch.tensor(tables)[:, :, None] * half
                    + torch.arange(half)[None, None, :]).reshape(b, -1).to(torch.int32)
    parts = [ref.paged_decode_partials(
        torch.tensor(q), pk, pv, chunk_tables[:, c:c + 1].contiguous(),
        (torch.tensor(lengths) - c * CHUNK).clamp(0, CHUNK).to(torch.int32))
        for c in range(nb * half)]
    want = np.asarray(pallas_paged(*(jnp.asarray(a) for a in (q, pool_k, pool_v, tables,
                                                               lengths)), interpret=True))
    merged = ref.merge_partials_local(parts).numpy()
    np.testing.assert_allclose(merged, want, rtol=0, atol=MERGE_ATOL)
    assert (merged[1] == 0).all() and (want[1] == 0).all()   # the zero-length request
    np.testing.assert_allclose(
        merged, ref.paged_decode(*(torch.tensor(a) for a in (q, pool_k, pool_v, tables,
                                                             lengths))).numpy(),
        rtol=0, atol=MERGE_ATOL)
