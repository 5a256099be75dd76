"""The other model families on the CPU, against the JAX package on bridged
weights: the Mamba2 and xLSTM blocks (outputs and every state tensor, from
zero and from a given state, a decode chain against the whole sequence),
cross-attention, ``T.prefill`` / ``T.decode_step`` of the seven archs the
port adds (logits and every cache leaf; zamba also with a trailing Mamba
layer), ``Server.generate`` (frontend embeds for internvl2 and seamless,
internvl2 also on the paged cache with ragged lengths), the reference's
refusals and the serve CLI.

fp32, ``rtol = atol = 1e-5`` as ``tests/test_torch_serve.py``; greedy
tokens, positions and page tables equal. The weights the reference
initialises to constants (norm weights, biases, the Mamba2 decay, step and
skip parameters, the xLSTM gate biases) get random values first, so that
every parameter of the blocks reaches the comparison.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.models import attention as JA
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.runtime.serve import ServeConfig as JServeConfig
from repro.runtime.serve import Server as JServer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke
from repro_torch.launch import serve as cli
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.mesh import make_mesh
from repro_torch.runtime.serve import ServeConfig, Server

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
NEW_ARCHS = ("qwen2-72b", "tinyllama-1.1b", "deepseek-7b", "zamba2-1.2b", "xlstm-350m",
             "seamless-m4t-medium", "internvl2-76b")
RECURRENT = ("zamba2-1.2b", "xlstm-350m", "seamless-m4t-medium")
# leaves the reference initialises to constants: ones get 1 + noise, the
# rest noise (a_log small, so that the Mamba2 decay stays in (0, 1))
CONSTANT_LEAVES = {"ln1": 1, "ln2": 1, "ln_x": 1, "ln": 1, "final_norm": 1, "enc_norm": 1,
                   "norm_w": 1, "d_skip": 1, "bq": 0, "bk": 0, "bv": 0, "conv_b": 0,
                   "a_log": 0, "dt_bias": 0, "b_gates": 0, "b_in": 0}


def _cfgs(arch: str, **kw):
    return (dataclasses.replace(smoke(get_config(arch)), **kw),
            dataclasses.replace(jsmoke(jget(arch)), **kw))


def _jitter(tree, rng, key=""):
    """The numpy tree with every constant-initialised leaf made random."""
    if isinstance(tree, dict):
        return {k: _jitter(v, rng, k) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    if key in CONSTANT_LEAVES:
        a = (CONSTANT_LEAVES[key] + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
    return a


def _both(np_tree):
    """The same numpy tree as JAX arrays and as the port's tensors."""
    return jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree, device="cpu")


@functools.lru_cache(maxsize=None)
def _model(arch: str, n_layers: int | None = None):
    kw = {} if n_layers is None else {"n_layers": n_layers}
    cfg, jcfg = _cfgs(arch, **kw)
    np_params = _jitter(jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg)),
                        np.random.default_rng(7))
    return cfg, jcfg, np_params


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


def _tree_close(got, want, path="cache"):
    """Every leaf of the reference's tree against the port's same key."""
    if isinstance(want, dict):
        for k, v in want.items():
            _tree_close(got[k], v, f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, v in enumerate(want):
            _tree_close(got[i], v, f"{path}/{i}")
    else:
        _close(got, want, path)


def _embeds(cfg, rng, b: int):
    if not cfg.frontend_stub:
        return None
    return rng.normal(0, 0.02, (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _opt(x, fn):
    return None if x is None else fn(x)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_archs_listed_in_reference_order():
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS

    assert ARCHS == JARCHS


# ---------------------------------------------------------------------------
# the recurrent blocks
# ---------------------------------------------------------------------------

def _block_params(init, cfg, seed):
    return _both(_jitter(jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg)),
                         np.random.default_rng(seed)))


def _random_state(state_init, cfg, rng, b):
    """A random state of the block's shapes (``m`` and ``n`` of the xLSTM
    kept in their ranges: stabiliser finite, normaliser positive)."""
    out = {}
    for k, v in state_init(cfg, b).items():
        a = rng.normal(0, 0.3, np.shape(v)).astype(np.float32)
        if k == "n" and float(np.asarray(v).max()) == 1.0:   # sLSTM normaliser
            a = 1.0 + np.abs(a)
        out[k] = a
    return out


BLOCKS = {
    "mamba": ("zamba2-1.2b", JS.mamba_init, JS.mamba_apply, JS.mamba_state_init,
              S.mamba_apply, S.mamba_state_init),
    "mlstm": ("xlstm-350m", JS.mlstm_init, JS.mlstm_apply, JS.mlstm_state_init,
              S.mlstm_apply, S.mlstm_state_init),
    "slstm": ("xlstm-350m", JS.slstm_init, JS.slstm_apply, JS.slstm_state_init,
              S.slstm_apply, S.slstm_state_init),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_recurrent_block_matches_reference(block):
    """From zero and from a given state: the output and every returned
    state tensor; then three one-token steps (``mamba_decode`` for Mamba2)
    equal to one call over the same three tokens, in the port and against
    the reference."""
    arch, jinit, japply, jstate, apply, state_init = BLOCKS[block]
    cfg, jcfg = _cfgs(arch)
    japply = jax.jit(japply, static_argnums=2)
    jp, p = _block_params(jinit, jcfg, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1.0, (2, 5, cfg.d_model)).astype(np.float32)
    y, st = apply(p, torch.tensor(x), cfg)
    jy, jst = japply(jp, jnp.asarray(x), jcfg)
    _close(y, jy, f"{block} from zero")
    _tree_close(st, jst, f"{block} state from zero")
    given = _random_state(jstate, jcfg, rng, 2)
    y, st = apply(p, torch.tensor(x), cfg, {k: torch.tensor(v) for k, v in given.items()})
    jy, jst = japply(jp, jnp.asarray(x), jcfg, {k: jnp.asarray(v) for k, v in given.items()})
    _close(y, jy, f"{block} from a state")
    _tree_close(st, jst, f"{block} state from a state")
    for k, v in state_init(cfg, 2).items():
        assert v.dtype == torch.float32 and tuple(v.shape) == np.shape(given[k])
    # a 3-step chain equals the block over the same 3 tokens
    x3 = torch.tensor(x[:, :3])
    y_all, st_all = apply(p, x3, cfg, {k: torch.tensor(v) for k, v in given.items()})
    state = {k: torch.tensor(v) for k, v in given.items()}
    jstate_ = {k: jnp.asarray(v) for k, v in given.items()}
    step = S.mamba_decode if block == "mamba" else None
    for i in range(3):
        if step is not None:
            yi, state = step(p, x3[:, i : i + 1], state, cfg)
            jyi, jstate_ = jax.jit(JS.mamba_decode, static_argnums=3)(
                jp, jnp.asarray(x[:, i : i + 1]), jstate_, jcfg)
        else:
            yi, state = apply(p, x3[:, i : i + 1], cfg, state)
            jyi, jstate_ = japply(jp, jnp.asarray(x[:, i : i + 1]), jcfg, jstate_)
        _close(yi, y_all[:, i : i + 1].detach().numpy(), f"{block} step {i} vs sequence")
        _close(yi, jyi, f"{block} step {i}")
    _tree_close(state, jax.tree.map(np.asarray, jstate_), f"{block} chained state")
    _tree_close(state, {k: v.numpy() for k, v in st_all.items()}, f"{block} chain vs sequence")


def test_cross_attention_matches_reference():
    cfg, jcfg = _cfgs("seamless-m4t-medium")
    jp, p = _block_params(JA.attn_init, jcfg, 5)
    rng = np.random.default_rng(6)
    mem = rng.normal(0, 1.0, (2, 7, cfg.d_model)).astype(np.float32)
    x = rng.normal(0, 1.0, (2, 3, cfg.d_model)).astype(np.float32)
    kv = A.cross_kv(p, torch.tensor(mem), cfg)
    jkv = JA.cross_kv(jp, jnp.asarray(mem), jcfg, JCtx())
    _tree_close(kv, jkv, "cross_kv")
    _close(A.cross_attention(p, torch.tensor(x), kv, cfg),
           JA.cross_attention(jp, jnp.asarray(x), jkv, jcfg, JCtx()), "cross_attention")


# ---------------------------------------------------------------------------
# prefill and decode per arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_layers", [(a, None) for a in NEW_ARCHS]
                         + [("zamba2-1.2b", 5)])
def test_prefill_and_decode_match_reference(arch, n_layers):
    """Prefill logits and every cache or state leaf, then 3 decode steps
    (logits and leaves). ``n_layers`` 5 gives zamba a trailing Mamba2 layer
    after its two units (the smoke config has none)."""
    cfg, jcfg, np_params = _model(arch, n_layers)
    if n_layers == 5:
        assert T.zamba_layout(cfg) == (2, 1)
    jp, p = _both(np_params)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 6))
    emb = _embeds(cfg, rng, 2)
    jprefill = jax.jit(functools.partial(JT.prefill, cfg=jcfg, ctx=JCtx(), max_seq=24))
    jdecode = jax.jit(functools.partial(JT.decode_step, cfg=jcfg, ctx=JCtx()))
    jlog, jc = jprefill(jp, jnp.asarray(tokens), embeds=_opt(emb, jnp.asarray))
    log, c = T.prefill(p, torch.tensor(tokens), cfg, max_seq=24, embeds=_opt(emb, torch.tensor))
    _close(log, jlog, f"{arch} prefill logits")
    _tree_close(c, jc, f"{arch} prefill cache")
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1))
        jlog, jc, _ = jdecode(jp, jnp.asarray(tok), jc)
        log, c, _ = T.decode_step(p, torch.tensor(tok), c, cfg)
        _close(log, jlog, f"{arch} decode {i} logits")
        _tree_close(c, jc, f"{arch} decode {i} cache")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_generate_matches_reference(arch):
    """``Server.generate`` greedy tokens equal the JAX Server's, with the
    same numpy embeds for the frontend stubs."""
    cfg, jcfg, np_params = _model(arch)
    jp, p = _both(np_params)
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, cfg.vocab_size, (2, 7))
    emb = _embeds(cfg, rng, 2)
    srv = Server(cfg, ParallelCtx(), p, ServeConfig(max_seq=32, batch=2), device="cpu")
    jsrv = JServer(jcfg, JCtx(), jp, JServeConfig(max_seq=32, batch=2))
    out = srv.generate(prompt, 6, embeds=_opt(emb, torch.tensor))
    jout = jsrv.generate(jnp.asarray(prompt), 6, embeds=_opt(emb, jnp.asarray))
    assert out.shape == (2, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_internvl2_paged_ragged_matches_reference():
    """internvl2 on the paged cache, ragged right-padded prompts: the
    prefill's pages count the prepended embeds (``_prompt_rows``), so the
    tables, written lengths and logits equal the reference's, and so do
    the greedy tokens of the decode steps that follow."""
    cfg, jcfg, np_params = _model("internvl2-76b")
    jp, p = _both(np_params)
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab_size, (3, 8))
    lengths = np.array([8, 5, 3], np.int32)
    emb = _embeds(cfg, rng, 3)
    scfg = dict(max_seq=48, batch=3, paged=True, page_size=4)
    srv = Server(cfg, ParallelCtx(), p, ServeConfig(**scfg), device="cpu")
    jsrv = JServer(jcfg, JCtx(), jp, JServeConfig(**scfg))
    log, cache = srv.prefill(prompt, embeds=torch.tensor(emb), lengths=lengths)
    jlog, jcache = jsrv.prefill(jnp.asarray(prompt), embeds=jnp.asarray(emb),
                                lengths=jnp.asarray(lengths))
    _close(log, jlog, "paged prefill logits")
    np.testing.assert_array_equal(srv._written, lengths + cfg.frontend_tokens)
    np.testing.assert_array_equal(srv._written, jsrv._written)
    np.testing.assert_array_equal(srv._tables, jsrv._tables)
    assert [len(srv._pages[s]) for s in range(3)] == [4, 4, 3]
    tok = torch.argmax(log[:, -1:], dim=-1)
    jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
    for i in range(4):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        log, cache = srv.decode(tok, cache)
        jlog, jcache = jsrv.decode(jtok, jcache)
        _close(log, jlog, f"paged decode {i} logits")
        tok = torch.argmax(log[:, -1:], dim=-1)
        jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
    np.testing.assert_array_equal(srv._tables, jsrv._tables)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_paged_and_chunked_refused_off_the_attn_pattern(arch):
    """The reference's ``ValueError``s: a paged cache, at ``init_cache`` and
    at a paged Server's prefill, and a decode step with a prefill-lane
    chunk (even the no-op chunk)."""
    cfg, jcfg, np_params = _model(arch)
    jp, p = _both(np_params)
    msg = "paged KV cache requires block_pattern="
    with pytest.raises(ValueError, match=msg):
        JT.init_cache(jcfg, 2, 16, paged=True)
    with pytest.raises(ValueError, match=msg):
        T.init_cache(cfg, 2, 16, paged=True, device="cpu")
    prompt = np.ones((2, 4), np.int32)
    emb = _embeds(cfg, np.random.default_rng(0), 2)
    scfg = dict(max_seq=16, batch=2, paged=True, page_size=4)
    with pytest.raises(ValueError, match=msg):
        JServer(jcfg, JCtx(), jp, JServeConfig(**scfg)).prefill(
            jnp.asarray(prompt), embeds=_opt(emb, jnp.asarray))
    with pytest.raises(ValueError, match=msg):
        Server(cfg, ParallelCtx(), p, ServeConfig(**scfg), device="cpu").prefill(
            prompt, embeds=_opt(emb, torch.tensor))
    chunk = {"tokens": np.zeros((1, 4), np.int32), "table": np.zeros(4, np.int32),
             "start": 0, "length": 0}
    msg = "chunked prefill requires block_pattern="
    with pytest.raises(ValueError, match=msg):
        JT.decode_step(jp, jnp.ones((2, 1), jnp.int32), JT.init_cache(jcfg, 2, 16), jcfg,
                       chunk=jax.tree.map(jnp.asarray, chunk))
    with pytest.raises(ValueError, match=msg):
        T.decode_step(p, torch.ones((2, 1), dtype=torch.long),
                      T.init_cache(cfg, 2, 16, device="cpu"), cfg,
                      chunk={k: torch.as_tensor(v) for k, v in chunk.items()})


def test_xlstm_depth_refused():
    cfg, jcfg = _cfgs("xlstm-350m", n_layers=6)
    with pytest.raises(AssertionError, match="xlstm depth % 4 != 0"):
        JT.init_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(AssertionError, match="xlstm depth % 4 != 0"):
        T.init_params(cfg, device="cpu")


@pytest.fixture
def mesh(tmp_path):
    """A 1 x 1 mesh over a gloo world of one in this process, torn down
    after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    yield make_mesh(1, 1)
    dist.destroy_process_group()


def test_mesh_serving_of_the_families(mesh):
    """Under a mesh: zamba, xlstm and encdec raise ``NotImplementedError``
    naming ROADMAP Queue 1 item 6 (the Server and the model entry points);
    internvl2 takes the ``attn`` mesh path with its embeds cut to the
    rank's rows, and on a 1 x 1 mesh gives the no-mesh tokens."""
    for arch in RECURRENT:
        cfg, _, np_params = _model(arch)
        p = params_from_numpy(np_params, device="cpu")
        ctx = ParallelCtx(mesh=mesh)
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            Server(cfg, ctx, p, ServeConfig(max_seq=16, batch=2), device="cpu")
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            T.init_cache(cfg, 2, 16, device="cpu", ctx=ctx)
    cfg, _, np_params = _model("internvl2-76b")
    rng = np.random.default_rng(14)
    prompt = rng.integers(0, cfg.vocab_size, (2, 5))
    emb = torch.tensor(_embeds(cfg, rng, 2))
    outs = []
    for ctx in (ParallelCtx(mesh=mesh), ParallelCtx()):
        srv = Server(cfg, ctx, params_from_numpy(np_params, device="cpu"),
                     ServeConfig(max_seq=32, batch=2), device="cpu")
        outs.append(srv.generate(prompt, 4, embeds=emb))
    assert torch.equal(outs[0], outs[1])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _mesh_rank(rank, init_file, inputs, out_dir):
    """One of two gloo ranks on a 2 x 1 mesh (the batch over the data
    axis): internvl2's Server with the stub embeds, on the dense and on
    the paged cache; saves its tokens."""
    import datetime

    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=120)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=2,
                            rank=rank, timeout=timeout)
    mesh = make_mesh(2, 1, timeout=timeout)
    cfg = smoke(get_config("internvl2-76b"))
    inp = dict(np.load(inputs))
    params = _nest({k[len("params/"):]: v for k, v in inp.items() if k.startswith("params/")})
    out = {}
    for paged in (False, True):
        srv = Server(cfg, ParallelCtx(mesh=mesh), params_from_numpy(params, device="cpu"),
                     ServeConfig(max_seq=32, batch=4, paged=paged, page_size=8),
                     device="cpu")
        out[f"paged{int(paged)}"] = srv.generate(
            inp["prompt"], 4, embeds=torch.tensor(inp["embeds"])).numpy()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.destroy_process_group()


def test_embeds_cut_to_the_rank_rows_under_a_data_axis(tmp_path):
    """internvl2 on two gloo ranks (a 2 x 1 mesh: the batch over the data
    axis): each rank prefills its own rows of the tokens and of the
    embeds, and every rank's greedy tokens (gathered over the data group)
    equal the no-mesh port's (itself held to the JAX Server above), on
    both caches."""
    import torch.multiprocessing as tmp

    cfg, _, np_params = _model("internvl2-76b")
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, cfg.vocab_size, (4, 5)).astype(np.int32)
    emb = _embeds(cfg, rng, 4)
    np.savez(tmp_path / "inputs.npz", prompt=prompt, embeds=emb,
             **{f"params/{k}": v for k, v in _flat(np_params).items()})
    tmp.spawn(_mesh_rank, args=(str(tmp_path / "pg"), str(tmp_path / "inputs.npz"),
                                str(tmp_path)), nprocs=2, join=True)
    p = params_from_numpy(np_params, device="cpu")
    for paged in (False, True):
        scfg = ServeConfig(max_seq=32, batch=4, paged=paged, page_size=8)
        want = Server(cfg, ParallelCtx(), p, scfg, device="cpu").generate(
            prompt, 4, embeds=torch.tensor(emb)).numpy()
        for r in range(2):
            np.testing.assert_array_equal(
                np.load(tmp_path / f"rank{r}.npz")[f"paged{int(paged)}"], want,
                err_msg=f"rank {r}, paged={paged}")


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_serves_every_new_arch(arch, capsys):
    cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
              "--prompt-len", "8", "--gen", "4", "--batches", "1"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and out.rstrip().endswith("done")
    assert ("frontend stub" in out) == get_config(arch).frontend_stub


def test_cli_stub_embeds_as_the_reference_draws_them():
    """Batch i's embeds: 0.02 * randn from a generator seeded with i, of
    (requests, frontend_tokens, d_model), in the model's dtype."""
    cfg = smoke(get_config("internvl2-76b"))
    e = cli.stub_embeds(cfg, 3, 1, torch.bfloat16, torch.device("cpu"))
    want = torch.randn((3, cfg.frontend_tokens, cfg.d_model),
                       generator=torch.Generator().manual_seed(1)) * 0.02
    assert e.dtype == torch.bfloat16 and torch.equal(e, want.to(torch.bfloat16))
    assert cli.stub_embeds(smoke(get_config("qwen2-72b")), 3, 0, torch.float32, "cpu") is None


def _dtypes(tree):
    if isinstance(tree, dict):
        return {k: _dtypes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_dtypes(v) for v in tree)
    return str(tree.dtype).replace("torch.", "") if hasattr(tree, "dtype") else "int"


@pytest.mark.parametrize("arch", RECURRENT)
def test_bf16_dtypes_follow_the_reference(arch):
    """bf16 weights, a bf16 cache and (seamless) bf16 embeds, as the card
    serves them: every cache leaf and the logits take the reference's
    dtype (the recurrent states stay fp32)."""
    cfg, jcfg, np_params = _model(arch)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16)
                      if a.dtype == np.float32 else jnp.asarray(a), np_params)
    p = params_from_numpy(np_params, device="cpu", dtype=torch.bfloat16)
    rng = np.random.default_rng(15)
    tokens = rng.integers(0, cfg.vocab_size, (2, 4))
    emb = _embeds(cfg, rng, 2)
    jlog, jc = JT.prefill(jp, jnp.asarray(tokens), jcfg, JCtx(), max_seq=8,
                          dtype=jnp.bfloat16,
                          embeds=_opt(emb, lambda e: jnp.asarray(e, jnp.bfloat16)))
    log, c = T.prefill(p, torch.tensor(tokens), cfg, max_seq=8, dtype=torch.bfloat16,
                       embeds=_opt(emb, lambda e: torch.tensor(e, dtype=torch.bfloat16)))
    assert _dtypes(log) == str(jlog.dtype) == "bfloat16"
    want = jax.tree.map(lambda a: "int" if a.dtype == jnp.int32 else str(a.dtype), jc)
    assert _dtypes({k: c[k] for k in jc}) == jax.tree.map(
        lambda d: d, want, is_leaf=lambda d: isinstance(d, str))
    assert bool(torch.isfinite(log.float()).all())


def test_seamless_fp32_embeds_with_bf16_weights():
    """The reference's CLI draws fp32 embeds. With bf16 weights its encoder
    then computes in fp32 (JAX promotes), its cross K/V come out fp32, and
    its decoder's residual turns fp32 in the first cross-attention, which
    its layer scan refuses (a carry that changes dtype: a TypeError). The
    port promotes the same way (``layers.mm``: the fp32 operand decides),
    runs on in fp32 and casts into its bf16 self-attention cache; the
    card's callers pass embeds in the model's dtype instead."""
    cfg, jcfg, np_params = _model("seamless-m4t-medium")
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), np_params)
    p = params_from_numpy(np_params, device="cpu", dtype=torch.bfloat16)
    rng = np.random.default_rng(16)
    tokens = rng.integers(0, cfg.vocab_size, (2, 4))
    emb = _embeds(cfg, rng, 2)
    with pytest.raises(TypeError, match="carry"):
        JT.prefill(jp, jnp.asarray(tokens), jcfg, JCtx(), embeds=jnp.asarray(emb),
                   max_seq=8, dtype=jnp.bfloat16)
    jkv = JA.cross_kv(jax.tree.map(lambda t: t[0], jp["layers"])["xattn"],
                      jnp.asarray(emb), jcfg, JCtx())
    log, c = T.prefill(p, torch.tensor(tokens), cfg, max_seq=8, dtype=torch.bfloat16,
                       embeds=torch.tensor(emb))
    assert str(jkv[0].dtype) == "float32"
    assert [t.dtype for t in c["cross_kv"]] == [torch.float32, torch.float32]
    assert c["layers"]["k"].dtype == torch.bfloat16 and log.dtype == torch.float32
    assert bool(torch.isfinite(log).all())
