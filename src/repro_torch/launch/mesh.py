"""Production mesh construction with ER-Mapping placement (PyTorch port of
``repro.launch.mesh``).

``make_production_mesh`` is the canonical mesh: 16 x 16 ``("data",
"model")`` ranks a pod, two pods (``("pod", "data", "model")``) with
``multi_pod``. ``make_er_mesh`` applies the paper's Entwined Ring Mapping
as a rank permutation: the logical axes are the same, but logical
coordinate (g, r) sits at the rank that ``MAPPINGS[mapping](MeshTopology(
16, 16), 16, 16).device_order()[g, r]`` names within its pod, so that the
model-axis rings and the EP all-to-all follow the paper's placement on the
physical torus (ranks numbered row by row over the 16 x 16 grid).

These run over an initialised ``torch.distributed`` world (a real one, or
the dry run's fake world of 256 or 512 ranks); they create process groups
and so are collective: every rank calls them in the same order.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from repro_torch.core.er_mapping import MAPPINGS
from repro_torch.core.topology import MeshTopology
from repro_torch.parallel.mesh import Mesh, make_mesh

POD = 16   # the 16 x 16 grid of one pod


def mesh_order(mapping: str, x: int = POD, dp: int = POD, tp: int = POD) -> np.ndarray:
    """``(dp, tp)``: the rank of each logical ``(data, model)`` coordinate
    under ``mapping`` (``baseline``, ``er`` or ``her``) on an ``x`` x
    ``x`` grid. Pure numpy: no process group."""
    if mapping not in MAPPINGS:
        raise ValueError(f"unknown mapping {mapping!r}; known: {sorted(MAPPINGS)}")
    return np.asarray(MAPPINGS[mapping](MeshTopology(x, x), dp, tp).device_order())


def _need(n_pods: int) -> None:
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n_pods * POD * POD:
        raise ValueError(
            f"need {n_pods * POD * POD} ranks, have {have} (initialise a "
            f"torch.distributed world of that size first; the dry run "
            f"uses the 'fake' backend)"
        )


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 ranks a pod in row-major order; two pods with ``multi_pod``."""
    n_pods = 2 if multi_pod else 1
    _need(n_pods)
    return make_mesh(POD, POD, pod=n_pods)


def make_er_mesh(*, multi_pod: bool = False, mapping: str = "er") -> Mesh:
    """The production mesh with the baseline / ER / HER placement: each
    pod's 256 ranks take the mapping's ``device_order()`` (dp = 16 groups
    x tp = 16 ranks)."""
    order = mesh_order(mapping)
    n_pods = 2 if multi_pod else 1
    _need(n_pods)
    return make_mesh(POD, POD, pod=n_pods, order=order)


def make_test_mesh(data: int = 2, model: int = 4) -> Mesh:
    """A small row-major mesh (tests, rehearsals)."""
    return make_mesh(data, model)
