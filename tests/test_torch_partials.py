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
from repro.kernels.flash_decode.ref import decode_ref
from repro_torch.kernels import registry
from repro_torch.kernels.flash_decode import ref
from repro_torch.kernels.flash_decode.flash_decode import flash_decode
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
