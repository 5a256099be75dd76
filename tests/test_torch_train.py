"""The port's training path on the CPU, against the JAX package on the same
numpy inputs and bridged parameters (``repro_torch.bridge``):

* the registry's five autograd Functions (outputs and input gradients)
  against the reference's ``jax.custom_vjp``s, whose kernel forwards run
  in interpret mode;
* ``T.forward``'s logits and aux for one arch per block pattern;
* ``loss_fn`` gradients per leaf on mixtral-8x22b's ``smoke()`` under
  ``dense``, ``esp`` and ``ep`` (the reference with ``use_kernels=True``,
  its Pallas kernels in interpret mode);
* three ``make_train_step`` steps (params, ``mu``, ``nu``, metrics);
* microbatching and remat against the plain step, within the port;
* ``cosine_lr``, clipping and ``SyntheticLM``;
* the CLI: a checkpoint the JAX trainer wrote after 2 steps, resumed by
  the port's CLI for 2 more, against the JAX trainer's 4 uninterrupted
  steps, and the log lines against the reference's;
* a 1 x 1 gloo mesh in this process: the train step, ``grad_compress``,
  ``--mesh 1x1`` and ``--pod-sync`` equal to the no-mesh run bit for bit
  (four ranks: ``tests/test_torch_mesh_train.py``).

Tolerances (fp32): forward values and gradients ``rtol = atol = 1e-5``
(summation order only); after AdamW steps see ``_state_close``.
"""

import dataclasses
import functools
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.kernels import registry as JR
from repro.launch import train as jcli
from repro.models import transformer as JT
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.runtime import data as JD
from repro.runtime import optimizer as JO
from repro.runtime import train as JTR
from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke
from repro_torch.kernels import registry as R
from repro_torch.launch import train as cli
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.mesh import make_mesh
from repro_torch.runtime import optimizer as O
from repro_torch.runtime import train as TR
from repro_torch.runtime.data import DataConfig, SyntheticLM

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, what="", **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=what, **(tol or TOL))


def _tree_close(got, want, path="", **tol):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k, v in want.items():
            _tree_close(got[k], v, f"{path}/{k}", **tol)
    elif want is None:
        assert got is None, path
    else:
        _close(got, want, path, **tol)


@functools.lru_cache(maxsize=None)
def _model(arch: str, n_layers: int | None = None):
    """Both packages' configs and one set of parameters as numpy, which each
    package takes from there (seeded draws of the port's ``init_params``,
    whose keys and layouts are the reference's: JAX's eager init would
    compile each of its ops for every new shape)."""
    kw = {} if n_layers is None else {"n_layers": n_layers}
    cfg = dataclasses.replace(smoke(get_config(arch)), **kw)
    jcfg = dataclasses.replace(jsmoke(jget(arch)), **kw)
    np_params = O.tree_map(lambda t: t.numpy(), T.init_params(cfg, seed=0, device="cpu"))
    return cfg, jcfg, np_params


def _batch(cfg, rng, b=2, s=16):
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": tokens, "labels": labels}
    if cfg.frontend_stub:
        out["embeds"] = rng.normal(0, 0.02, (b, cfg.frontend_tokens, cfg.d_model)).astype(
            np.float32)
    return out


def _opt(x, fn):
    return None if x is None else fn(x)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the registry's Functions against the reference's custom_vjps
# ---------------------------------------------------------------------------

SEGMENTS = [4, 16, 0, 9]       # rows of each bucket (one empty, one full)
CAP = 16


def _rows_case(rng, gpw=1):
    """Flat rows with gaps between bucket segments (dropped copies)."""
    g, d, f = len(SEGMENTS), 8, 12
    offsets, r = [], 0
    for c in SEGMENTS:
        offsets.append(r)
        r += c + 2                            # two dead rows after each segment
    x = rng.normal(0, 1, (r, d)).astype(np.float32)
    w = [rng.normal(0, 0.1, shape).astype(np.float32)
         for shape in ((g // gpw, d, f), (g // gpw, d, f), (g // gpw, f, d))]
    live = np.zeros(r, bool)
    for o, c in zip(offsets, SEGMENTS):
        live[o : o + c] = True
    return x, w, np.asarray(offsets, np.int32), np.asarray(SEGMENTS, np.int32), live


def _ffn_forms(rng, form):
    """(inputs as numpy, JAX function, port function, live-row mask of the
    output or None) of one kernel entry."""
    if form == "ragged":
        g, c, d, f = 4, 16, 8, 12
        x = rng.normal(0, 1, (g, c, d)).astype(np.float32)
        w = [rng.normal(0, 0.1, s).astype(np.float32)
             for s in ((g // 2, d, f), (g // 2, d, f), (g // 2, f, d))]
        gs = np.asarray([3, 16, 0, 9], np.int32)
        return ((x, *w),
                lambda *a: JR.expert_ffn(*a, jnp.asarray(gs), groups_per_weight=2,
                                         enabled=True, interpret=True),
                lambda *a: R.expert_ffn(*a, torch.from_numpy(gs), 2), None)
    x, w, offs, gs, live = _rows_case(rng)
    compact = form != "gather"
    kw = dict(capacity=CAP, compact_out=compact, fused=form == "fused")

    def jfn(*a):
        return JR.expert_ffn_from_rows(*a, jnp.asarray(offs), jnp.asarray(gs), enabled=True,
                                       interpret=True, **kw)

    def tfn(*a):
        return R.expert_ffn_from_rows(*a, torch.from_numpy(offs), torch.from_numpy(gs), **kw)

    return (x, *w), jfn, tfn, live if compact else None


@pytest.mark.parametrize("form", ["ragged", "gather", "compact", "fused", "attend"])
def test_functions_match_custom_vjp(form):
    """Each autograd Function's output and its gradients for every float
    input, under one random cotangent, against the JAX ``custom_vjp`` (its
    Pallas forward in interpret mode, its reference backward). Compact
    outputs compare on live rows only (the kernel leaves the others
    unspecified) and their cotangent is zero elsewhere."""
    rng = np.random.default_rng(3)
    if form == "attend":
        inputs = tuple(rng.normal(0, 1, s).astype(np.float32)
                       for s in ((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
        outs = []
        for causal, window in ((True, 8), (False, 0)):
            outs.append((lambda *a, c=causal, w=window: JR.attend(*a, causal=c, window=w,
                                                                   interpret=True),
                         lambda *a, c=causal, w=window: R.attend(*a, causal=c, window=w)))
        cases = [(inputs, j, t, None) for j, t in outs]
    else:
        cases = [_ffn_forms(rng, form)]
    for inputs, jfn, tfn, live in cases:
        jin = [jnp.asarray(a) for a in inputs]
        jout, vjp = jax.vjp(jfn, *jin)
        ct = rng.normal(0, 1, jout.shape).astype(np.float32)
        if live is not None:
            ct[~live] = 0.0
        jgrads = vjp(jnp.asarray(ct))
        tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
        tout = tfn(*tin)
        assert tout.grad_fn is not None
        tgrads = torch.autograd.grad(tout, tin, torch.from_numpy(ct))
        rows = slice(None) if live is None else live
        _close(tout[rows], np.asarray(jout)[rows], f"{form} output")
        for i, (got, want) in enumerate(zip(tgrads, jgrads)):
            _close(got, want, f"{form} grad of input {i}")


# ---------------------------------------------------------------------------
# forward, loss gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x22b", "zamba2-1.2b",
                                  "xlstm-350m", "seamless-m4t-medium", "internvl2-76b"])
def test_forward_matches_reference(arch):
    """Logits and aux (``loss``, ``counts``) of ``T.forward``, one arch per
    block pattern (attn dense, attn MoE, zamba, xlstm, encdec, the vlm
    stub), with zamba at 5 layers so that a trailing Mamba2 layer runs."""
    cfg, jcfg, np_params = _model(arch, 5 if arch == "zamba2-1.2b" else None)
    batch = _batch(cfg, np.random.default_rng(1))
    jl, jaux = jax.jit(functools.partial(JT.forward, cfg=jcfg, ctx=JCtx()))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(batch["tokens"]),
        embeds=_opt(batch.get("embeds"), jnp.asarray))
    tl, taux = T.forward(params_from_numpy(np_params), torch.from_numpy(batch["tokens"]), cfg,
                         ParallelCtx(), embeds=_opt(batch.get("embeds"), torch.from_numpy))
    assert tl.shape == (2, 16, cfg.vocab_size)
    _close(tl, jl, "logits")
    _close(taux["loss"], jaux["loss"], "aux loss")
    _close(taux["counts"], jaux["counts"], "aux counts")


@pytest.mark.parametrize("impl", ["dense", "esp", "ep"])
def test_loss_grads_match_reference(impl):
    """``loss_fn``'s value and gradient of every leaf on mixtral-8x22b's
    ``smoke()``; the reference with ``use_kernels=True`` (its ragged,
    gather/scatter or fused FFN and flash attention in interpret mode under
    their ``custom_vjp``s), the port as a CPU run takes it (``esp``
    through the registry's Functions)."""
    cfg, jcfg, np_params = _model("mixtral-8x22b")
    batch = _batch(cfg, np.random.default_rng(2))
    jctx = JCtx(moe_impl=impl, use_kernels=True)
    loss = functools.partial(JTR.loss_fn, cfg=jcfg, ctx=jctx)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, np_params), _jbatch(batch))
    params = params_from_numpy(np_params)
    tg, tmet = TR.grads_of(params, _tbatch(batch), cfg, ParallelCtx(moe_impl=impl))
    _close(tmet["loss"], jloss, "loss")
    _close(tmet["ce"], jmet["ce"], "ce")
    _close(tmet["aux"], jmet["aux"], "aux")
    _tree_close(tg, jax.tree.map(np.asarray, jg), "grads")


# ---------------------------------------------------------------------------
# train steps, microbatches, remat
# ---------------------------------------------------------------------------

APART = 1e-3   # gradients two runs round apart by more than this share


def _state_close(got, want, loose=None, bound: float = 0.0):
    """A state after AdamW steps against the reference's: the step equal;
    ``mu`` at the gradients' 1e-5, and ``nu``, a mean of squared gradients,
    through its square root (the gradients' own scale) at the same 1e-5;
    the params at 1e-5, except the elements of ``loose`` (a tree of masks:
    a gradient the two runs rounded apart at some step), held at
    ``bound``, the most two AdamW runs can part there (see the test)."""
    _close(got["opt"]["step"], want["opt"]["step"], "step", rtol=0, atol=0)
    _tree_close(got["opt"]["mu"], want["opt"]["mu"], "mu")
    _tree_close(O.tree_map(torch.sqrt, got["opt"]["nu"]),
                jax.tree.map(np.sqrt, want["opt"]["nu"]), "sqrt(nu)")
    if loose is None:
        _tree_close(got["params"], want["params"], "params")
        return
    for a, b, m in zip(O.leaves(got["params"]), jax.tree.leaves(want["params"]),
                       O.leaves(loose)):
        a, b, m = _np(a), np.asarray(b), _np(m)
        _close(a[~m], b[~m], "params")
        assert np.all(np.abs(a[m] - b[m]) <= bound), "params near a zero gradient"


def test_three_train_steps_match_reference():
    """Three ``make_train_step`` steps on dbrx-132b's ``smoke()`` under EP
    from the same bridged state and ``SyntheticLM`` batches: the metrics,
    params, ``mu`` and ``nu`` after each step.

    Which elements loosen, and why: AdamW moves an element by ``lr * m /
    (sqrt(v) + eps)``, a ratio near +-1 whatever the gradient's size, so a
    gradient the two packages round apart by a large share of its value
    (a near-zero one) can move its parameter by a different part of
    ``lr``. Such elements, those whose gradients in the two packages part
    by more than ``APART`` of their value at some step (994 of 205632 here;
    the test requires fewer than 1%), are held at ``2 *
    sum(lr)``, the most two runs can part. A zero gradient (the embedding
    rows of tokens absent from the batches) gives a zero step on both
    sides and stays at 1e-5, as does every other element."""
    cfg, jcfg, np_params = _model("dbrx-132b")
    opt = O.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jstate = {"params": jax.tree.map(jnp.asarray, np_params)}
    jstate["opt"] = JO.adamw_init(jstate["params"])
    state = params_from_numpy(jax.tree.map(np.asarray, jstate))
    ctx, jctx = ParallelCtx(moe_impl="ep"), JCtx(moe_impl="ep")
    jstep = jax.jit(JTR.make_train_step(jcfg, jctx, jopt))
    jgrad = jax.jit(jax.grad(lambda p, b: JTR.loss_fn(p, b, jcfg, jctx)[0]))
    step = TR.make_train_step(cfg, ctx, opt)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 4, 16))
    jdata = JD.SyntheticLM(JD.DataConfig(jcfg.vocab_size, 4, 16))
    loose = [np.zeros(p.shape, bool) for p in O.leaves(state["params"])]
    moved = 0.0
    for i in range(3):
        gt, _ = TR.grads_of(state["params"], data.batch_at(i), cfg, ctx)
        gj = jgrad(jstate["params"], jdata.batch_at(i))
        for m, a, b in zip(loose, O.leaves(gt), jax.tree.leaves(gj), strict=True):
            m |= np.abs(_np(a) - np.asarray(b)) > APART * np.abs(np.asarray(b))
        jstate, jmet = jstep(jstate, jdata.batch_at(i))
        state, met = step(state, data.batch_at(i))
        assert set(met) == set(jmet) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for k in met:
            _close(met[k], jmet[k], f"step {i} {k}")
        moved += 2 * float(met["lr"])
        _state_close(state, jax.tree.map(np.asarray, jstate),
                     O.tree_map(torch.from_numpy, _unflatten(state["params"], loose)), moved)
    n_loose = sum(int(m.sum()) for m in loose)
    assert 0 < n_loose < sum(m.size for m in loose) // 100


def _unflatten(template, flat: list):
    """``flat`` (in ``optimizer.leaves`` order) in ``template``'s tree."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def _clone(tree):
    return O.tree_map(torch.clone, tree)


def test_microbatches_equal_one_batch():
    """Two microbatches of 4 equal one batch of 8 (clipping off, so the
    mean of the microbatch gradients is the batch gradient)."""
    cfg = smoke(get_config("llama3.2-1b"))
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=1e9)
    b = SyntheticLM(DataConfig(cfg.vocab_size, 8, 16)).batch_at(0)
    micro = {k: v.reshape(2, 4, 16) for k, v in b.items()}
    s1 = TR.init_state(cfg, device="cpu")
    s2 = _clone(s1)
    s1, m1 = TR.make_train_step(cfg, ParallelCtx(), opt)(s1, b)
    s2, m2 = TR.make_train_step(cfg, ParallelCtx(), opt, microbatches=2)(s2, micro)
    _tree_close(s2["params"], O.tree_map(_np, s1["params"]), "params")
    _close(m2["loss"], _np(m1["loss"]), "loss")


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "zamba2-1.2b", "seamless-m4t-medium"])
def test_remat_equals_no_remat(arch):
    """``ctx.remat`` recomputes each layer in the backward: the gradients
    are bit-identical to the step without it (the same ops on the same
    inputs on the CPU); mixtral under ESP, so the recompute goes through
    the registry's Functions."""
    cfg = smoke(get_config(arch))
    params = T.init_params(cfg, seed=1, device="cpu")
    batch = _tbatch(_batch(cfg, np.random.default_rng(4)))
    g0, m0 = TR.grads_of(params, batch, cfg, ParallelCtx(moe_impl="esp"))
    g1, m1 = TR.grads_of(params, batch, cfg, ParallelCtx(moe_impl="esp", remat=True))
    for a, b in zip(O.leaves(g0), O.leaves(g1)):
        assert torch.equal(a, b)
    assert torch.equal(m0["loss"], m1["loss"])


# ---------------------------------------------------------------------------
# schedule, clipping, data
# ---------------------------------------------------------------------------

def test_cosine_lr_clip_and_synthetic_lm():
    cfg = O.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.2)
    jcfg = JO.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.2)
    steps = np.arange(0, 50, 3, dtype=np.int32)
    _close(O.cosine_lr(cfg)(torch.from_numpy(steps)), JO.cosine_lr(jcfg)(jnp.asarray(steps)),
           "cosine_lr", rtol=1e-6, atol=0)
    # clipping: a gradient far above clip_norm moves a leaf by the clipped
    # step; the reported norm is the one before clipping
    rng = np.random.default_rng(5)
    p = {"a": rng.normal(0, 1, (3, 4)).astype(np.float32), "b": np.ones(5, np.float32)}
    g = {"a": rng.normal(0, 1e3, (3, 4)).astype(np.float32),
         "b": rng.normal(0, 1e3, 5).astype(np.float32)}
    c = O.AdamWConfig(lr=0.1, warmup_steps=0, clip_norm=1.0)
    jc = JO.AdamWConfig(lr=0.1, warmup_steps=0, clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, p)
    jnew, jopt, jm = jax.jit(JO.adamw_update, static_argnums=3)(
        jax.tree.map(jnp.asarray, g), JO.adamw_init(jp), jp, jc)
    tp = params_from_numpy(p)
    tnew, topt, tm = O.adamw_update(params_from_numpy(g), O.adamw_init(tp), tp, c)
    assert float(tm["grad_norm"]) > 1e3
    _close(tm["grad_norm"], jm["grad_norm"], "grad_norm")
    _tree_close(tnew, jax.tree.map(np.asarray, jnew), "clipped params")
    _tree_close(topt["mu"], jax.tree.map(np.asarray, jopt["mu"]), "clipped mu")
    # SyntheticLM: the same (seed, step, host_id) gives the reference's
    # tokens and labels; hosts split the global batch; a step replays
    for n_hosts, host_id in ((1, 0), (2, 1)):
        d = SyntheticLM(DataConfig(256, 4, 12, seed=7, n_hosts=n_hosts, host_id=host_id))
        jd = JD.SyntheticLM(JD.DataConfig(256, 4, 12, seed=7, n_hosts=n_hosts,
                                          host_id=host_id))
        for step in (0, 3):
            got, want = d.batch_at(step), jd.batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                assert got[k].shape == (4 // n_hosts, 12)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(d.batch_at(3)["tokens"], next(
            b for i, b in zip(range(4), d) if i == 3)["tokens"])
    with pytest.raises(ValueError, match="divide"):
        SyntheticLM(DataConfig(256, 3, 12, n_hosts=2))


# ---------------------------------------------------------------------------
# the CLI: a JAX checkpoint resumed by the port, the log lines
# ---------------------------------------------------------------------------

LOG = re.compile(r"step +(\d+) loss (\S+) ce (\S+) gnorm (\S+) lr (\S+) \S+s$")


def _run_jax_cli(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    jcli.main()
    return capsys.readouterr().out


def _log_values(out: str) -> dict:
    return {int(m.group(1)): [float(v) for v in m.groups()[1:]]
            for m in map(LOG.match, out.splitlines()) if m}


def test_cli_resumes_reference_checkpoint(monkeypatch, capsys, tmp_path):
    """The JAX trainer runs 4 steps and checkpoints after 2 (``--ckpt-every
    2``; 20 warm-up steps make its schedule that of a 2-step run); the
    port's CLI (``--device cpu``) restores the step-2 checkpoint alone
    (params, the fp32 moments, the int32 step, the data cursor) and takes
    steps 2 and 3. Its final checkpoint equals the JAX trainer's after the
    4 uninterrupted steps (``_state_close``), and its log lines carry the
    reference's fields and values (the printed digits within 1e-3
    relative)."""
    args = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2", "--seq", "16",
            "--log-every", "1"]
    part, whole = tmp_path / "part", tmp_path / "whole"
    ref = _log_values(_run_jax_cli(monkeypatch, capsys, [
        *args, "--steps", "4", "--ckpt-dir", str(whole), "--ckpt-every", "2"]))
    part.mkdir()
    for suffix in ("", ".meta"):
        shutil.copy(whole / f"ckpt_00000002.npz{suffix}", part)
    part, whole = str(part), str(whole)
    state, history = cli.main([*args, "--steps", "4", "--ckpt-dir", part, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[restore] resumed from step 2" in out
    assert "[ckpt] final at 4" in out
    got = _log_values(out)
    assert sorted(got) == [2, 3] and [r["step"] for r in history] == [2, 3]
    for step, vals in got.items():
        np.testing.assert_allclose(vals, ref[step], rtol=1e-3, err_msg=f"step {step}")
    template = O.tree_map(_np, state)
    want, meta = JCheckpointManager(whole).restore(template)
    assert meta["data_step"] == 4
    _state_close(state, jax.tree.map(np.asarray, want))
    # the port's own final checkpoint restores in the reference
    back, meta = JCheckpointManager(part).restore(template)
    assert meta["step"] == 4
    _state_close(state, jax.tree.map(np.asarray, back))


def test_bridge_carries_bf16_state():
    """A bf16 JAX train state (bf16 params, fp32 moments, the int32 step)
    crosses bit for bit."""
    _, _, np_params = _model("mixtral-8x22b")
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key == "router" else a.astype(jnp.bfloat16), np_params)
    np_state = jax.tree.map(np.asarray, {"params": params, "opt": JO.adamw_init(params)})
    assert np_state["params"]["embed"].dtype.name == "bfloat16"
    state = params_from_numpy(np_state)
    assert state["opt"]["step"].dtype == torch.int32
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["params"]["layers"]["moe"]["router"].dtype == torch.float32
    assert state["opt"]["mu"]["embed"].dtype == torch.float32
    for a, b in zip(O.leaves(state["params"]), jax.tree.leaves(np_state["params"])):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# a mesh of one rank: the same training, bit for bit
# ---------------------------------------------------------------------------

def _states_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(O.leaves(a), O.leaves(b), strict=True))


def test_training_under_a_mesh_raises(tmp_path):
    """On a 1 x 1 gloo mesh in this process the train step (EP over the
    all-to-all legs, the kernels' plain versions and the plain path), and
    with ``grad_compress=True`` (taken and unused, as in the reference),
    equals the no-mesh step bit for bit; so do the CLI's ``--mesh 1x1``
    (its own world of one, torn down after) and ``--pod-sync`` (no pod
    axis: nothing to sync): metrics bit for bit, states too but for
    dbrx's under ``--mesh``, where ``moe_impl="auto"`` serves EP against
    the no-mesh run's dense oracle (within 1e-5)."""
    cfg = smoke(get_config("dbrx-132b"))
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(3)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (2, 8))) for k in ("tokens",
                                                                                 "labels")}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        for uk in ("auto", False):
            runs = {}
            for name, ctx, compress in (
                ("no mesh", ParallelCtx(moe_impl="ep", use_kernels=uk), False),
                ("mesh", ParallelCtx(mesh=mesh, moe_impl="ep", use_kernels=uk), False),
                ("grad_compress", ParallelCtx(moe_impl="ep", use_kernels=uk), True),
            ):
                state = TR.init_state(cfg, device="cpu", ctx=ctx)
                step = TR.make_train_step(cfg, ctx, opt, grad_compress=compress)
                mets = []
                for _ in range(2):
                    state, met = step(state, batch)
                    mets.append({k: float(v) for k, v in met.items()})
                runs[name] = state, mets
            want, want_m = runs["no mesh"]
            for name in ("mesh", "grad_compress"):
                assert runs[name][1] == want_m, (uk, name)
                assert _states_equal(runs[name][0], want), (uk, name)
    finally:
        dist.destroy_process_group()
    for arch in ("llama3.2-1b", "dbrx-132b"):
        base = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
                "--seq", "8"]
        want_state, want = cli.main(base)
        for extra in (["--mesh", "1x1"], ["--pod-sync", "5"],
                      ["--mesh", "1x1", "--pod-sync", "1"]):
            state, got = cli.main([*base, *extra])
            assert [{k: v for k, v in r.items() if k != "seconds"} for r in got] == \
                [{k: v for k, v in r.items() if k != "seconds"} for r in want], extra
            assert not dist.is_initialized()
            if arch == "llama3.2-1b" or "--mesh" not in extra:
                assert _states_equal(state, want_state), (arch, extra)
            else:   # moe_impl "auto": the dense oracle with no mesh, EP on the mesh
                _tree_close(O.tree_map(_np, state), O.tree_map(_np, want_state))


@pytest.mark.parametrize("spec,world,want", [
    ("auto", 1, None), ("auto", 2, (1, 2)), ("auto", 4, (1, 4)), ("auto", 6, (3, 2)),
    ("auto", 16, (2, 8)), ("auto", 24, (3, 8)), ("2x2", 4, (2, 2)), ("1x1", 1, (1, 1)),
])
def test_cli_mesh_shape(spec, world, want):
    """``--mesh`` over a world: ``auto`` takes the reference CLI's model
    axis (the largest power of two up to 8 dividing the world, the rest
    data); a ``DxM`` that does not cover the world is refused."""
    assert cli.mesh_shape(spec, world) == want
    with pytest.raises(ValueError, match="needs 4 ranks"):
        cli.mesh_shape("2x2", 2)
