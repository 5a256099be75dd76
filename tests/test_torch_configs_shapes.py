"""The port's config helpers (``repro_torch.configs.base``) against the
reference's ``repro.configs.base`` for all ten architectures:
``subquadratic``, ``param_count``, ``active_param_count``, the dry run's
shape cells (``SHAPES``, ``shapes_for``), and ``param_count()`` against
the elements ``T.init_params`` builds at full size on fake tensors (no
memory allocated).

``param_count`` is the reference's approximate count: it leaves out the
norms, the routers and the attention biases, counts a decoder layer of the
encoder-decoder without its cross-attention, and approximates a Mamba2
layer by 6 d^2 and an xLSTM block by 5 d^2. The test names those leaves
and holds every other element exactly."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget
from repro.configs import shapes_for as j_shapes_for
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_config, shapes_for
from repro_torch.models import transformer as T

# the matrices param_count counts, by leaf name
COUNTED = {"embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
# subtrees it approximates (a Mamba2 layer 6 d^2, an xLSTM block 5 d^2) or
# leaves out (the decoder's cross-attention)
APPROXIMATED = {"units", "trailing"}
LEFT_OUT = {"xattn"}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif tree is not None:
        yield path, tree.numel()


def test_archs_in_the_reference_order():
    assert ARCHS == tuple(J_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_helpers_match_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert cfg.subquadratic == jcfg.subquadratic
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert [s.name for s in shapes_for(cfg)] == [s.name for s in j_shapes_for(jcfg)]


def test_shapes_match_reference():
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        j = J_SHAPES[name]
        assert isinstance(s, ShapeConfig)
        assert (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode) == (
            j.name, j.seq_len, j.global_batch, j.kind, j.is_decode)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_against_fake_init(arch):
    """``param_count()`` equals the full-size ``init_params``' elements,
    but for the leaves it leaves out and the blocks it approximates."""
    cfg = get_config(arch)
    with FakeTensorMode():
        params = T.init_params(cfg, dtype=torch.bfloat16, device="cpu")
    counted = approx = 0
    for path, n in _leaves(params):
        if path[0] in APPROXIMATED:
            approx += n
        elif path[-1] in COUNTED and not LEFT_OUT & set(path):
            counted += n
        else:
            assert path[-1] in {"ln1", "ln2", "ln_x", "final_norm", "enc_norm", "router",
                                "bq", "bk", "bv"} or "xattn" in path, path
    per_block = {"zamba": 6, "xlstm": 5}.get(cfg.block_pattern, 0) * cfg.d_model ** 2
    assert counted + cfg.n_layers * per_block == cfg.param_count()
    assert (approx > 0) == (per_block > 0)
