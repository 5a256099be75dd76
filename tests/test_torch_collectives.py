"""Bucket dispatch metadata and the local EP path of the port against the
JAX package. Integer metadata must match exactly (sentinels and
over-capacity copies included); float outputs within 1e-5 (fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import collectives as JC
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.parallel.placement import PlacementTable as JTable
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.placement import PlacementTable

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


def _ids(rng, n, k, n_buckets, n_sentinel):
    """Bucket ids with a skew (so some buckets overflow) and a few sentinel
    copies past every real bucket (masked tokens / unowned copies)."""
    ids = rng.choice(n_buckets, size=(n, k), p=np.linspace(3, 1, n_buckets) /
                     np.linspace(3, 1, n_buckets).sum())
    flat = ids.reshape(-1)
    flat[rng.choice(flat.size, n_sentinel, replace=False)] = n_buckets + 1
    return flat.reshape(n, k).astype(np.int32)


@pytest.mark.parametrize("n,k,n_buckets,cap,n_sentinel",
                         [(24, 2, 5, 4, 3), (40, 4, 12, 8, 7), (6, 2, 3, 8, 0)])
def test_dispatch_metadata_and_dispatch_match_exactly(n, k, n_buckets, cap, n_sentinel):
    rng = np.random.default_rng(n)
    ids = _ids(rng, n, k, n_buckets, n_sentinel)
    got = C.dispatch_metadata(_t(ids), n_buckets, cap)
    want = JC.dispatch_metadata(jnp.asarray(ids), n_buckets, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = rng.standard_normal((n, 8)).astype(np.float32)
    bufs, slots, keep = C.bucket_dispatch(_t(x), _t(ids), n_buckets, cap)
    jb, js, jk = JC.bucket_dispatch(jnp.asarray(x), jnp.asarray(ids), n_buckets, cap)
    np.testing.assert_array_equal(bufs.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(js))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(C.kept_counts(_t(ids), keep, n_buckets).numpy(),
                                  np.asarray(JC.kept_counts(jnp.asarray(ids), jk, n_buckets)))
    assert (~keep.numpy()).sum() >= n_sentinel
    y = rng.standard_normal((n_buckets, cap, 8)).astype(np.float32)
    wts = rng.random((n, k)).astype(np.float32)
    np.testing.assert_allclose(
        C.bucket_combine(_t(y), _t(ids), slots, keep, _t(wts)).numpy(),
        np.asarray(JC.bucket_combine(jnp.asarray(y), jnp.asarray(ids), js, jk,
                                     jnp.asarray(wts))), **TOL)


def test_choose_slots_replicas_and_sentinel():
    rng = np.random.default_rng(7)
    table = PlacementTable.uniform(4, 12, 3)
    jtable = JTable.uniform(4, 12, 3)
    for e, dev in ((0, 2), (0, 3), (2, 1)):
        for t in (table, jtable):
            t.commit(e, t.try_reserve(e, dev))
    ids = rng.integers(0, 5, (30, 2)).astype(np.int32)   # 4 = masked sentinel
    slot_of, n_rep = table.device_view("cpu")
    got = C.choose_slots(_t(ids), slot_of, n_rep, sentinel=13)
    want = JC.choose_slots(jnp.asarray(ids), *jtable.device_view(), sentinel=13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[ids == 4] == 13).all()
    # the % 997 spread wraps past 997 copies exactly like the reference
    big = rng.integers(0, 4, (600, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        C.choose_slots(_t(big), slot_of, n_rep).numpy(),
        np.asarray(JC.choose_slots(jnp.asarray(big), *jtable.device_view())))


def test_placement_views_and_device_cache():
    table = PlacementTable.uniform(4, 12, 3)
    v1 = table.device_view("cpu")
    assert table.device_view("cpu") is v1            # cached between commits
    slot = table.try_reserve(1, 3)
    assert table.device_view("cpu") is v1            # pending is invisible
    assert 3 in table.replica_devices(1) and 3 not in table.replica_devices(1, False)
    table.commit(1, slot)
    v2 = table.device_view("cpu")
    assert v2 is not v1 and table.version == 1
    assert v2[1].dtype == torch.int32 and int(v2[1][1]) == 2
    table.check()
    for got, want in zip(C.tiled_placement(3, 4, 10), JC.tiled_placement(3, 4, 10)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(C.uniform_placement(4, 8), JC.uniform_placement(4, 8)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_validate_ep_chunks_and_capacity():
    assert C.bucket_capacity(100, 1, 1.0, 3) == JC.bucket_capacity(100, 1, 1.0, 3) == 34
    assert C.bucket_capacity(2, 2, 1.0, 20) == 8
    assert C.validate_ep_chunks(2, 12) == 2
    for bad in (0, True, 1.5):
        with pytest.raises(ValueError, match="positive int"):
            C.validate_ep_chunks(bad)
    with pytest.raises(ValueError, match="does not divide"):
        C.validate_ep_chunks(5, 12)


@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_ep_moe_local_matches_reference_and_chunks_bit_identical(cf):
    """Local EP at capacity 1.0 (drops) and 4.0, with masked tokens and a
    replicated expert; ep_chunks=2 and 4 are bit-identical to 1."""
    rng = np.random.default_rng(11)
    n_slots, e, d, f, k = 8, 4, 16, 12, 2
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    ids = rng.integers(0, e + 1, (3, 5, k)).astype(np.int32)   # e = masked
    wts = rng.random((3, 5, k)).astype(np.float32)
    sw = {n: (rng.standard_normal(s) * 0.1).astype(np.float32) for n, s in
          (("w_gate", (n_slots, d, f)), ("w_up", (n_slots, d, f)),
           ("w_down", (n_slots, f, d)))}
    table, jtable = PlacementTable.uniform(e, n_slots, 2), JTable.uniform(e, n_slots, 2)
    for t in (table, jtable):
        t.commit(1, t.try_reserve(1, 3))
    want = JC.ep_moe_local(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(wts),
                           {n: jnp.asarray(v) for n, v in sw.items()},
                           *jtable.device_view(), JCtx(use_kernels=False), cf, n_slots)
    outs = []
    for kc in (1, 2, 4):
        outs.append(C.ep_moe_local(_t(x), _t(ids), _t(wts), {n: _t(v) for n, v in sw.items()},
                                   *table.device_view("cpu"), ParallelCtx(ep_chunks=kc),
                                   cf, n_slots))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), **TOL)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="does not divide"):
        C.ep_moe_local(_t(x), _t(ids), _t(wts), {n: _t(v) for n, v in sw.items()},
                       *table.device_view("cpu"), ParallelCtx(ep_chunks=3), cf, n_slots)
