"""A ``("data", "model")`` mesh of ``torch.distributed`` ranks, optionally
under a leading ``"pod"`` axis (PyTorch port of ``repro.launch.mesh``'s
meshes for the serving path).

Logical coordinate ``(g, r)`` of pod ``p`` sits at global rank ``p *
data * model + order[g, r]``. ``order`` defaults to the row-major order in
which ``make_mesh_compat`` lays host devices out (rank ``g * model + r``),
so the port's model index equals the JAX ``axis_index("model")``; a
placement (``launch.mesh.make_er_mesh``: the paper's ER-Mapping) passes a
permutation instead. Each rank belongs to one *model group* (the ranks of
its pod and data index: the EP all-to-all, the decode ownership sum and the
LSE merge run there), one *data group* (the ranks of its model index in
every pod: the batch axes, ``("pod", "data")`` in the reference; the
balancer's expert counts are summed there) and, with ``pod > 1``, one *pod
group* (the ranks of its data and model index across pods).

``torch.distributed.new_group`` numbers a group's members in the order of
their global ranks, not in the order it was given them. Where a
permutation makes the two differ, ``Mesh.model_order`` and
``Mesh.batch_order`` give the group rank of each logical index, and the
collectives that place blocks by rank (``parallel.collectives``'
``all_to_all``, ``all_gather_dim``, ``reduce_scatter_dim``) take them, so
that every block lands at its logical index; they are ``None`` for the
row-major order.

The backend follows the device: NCCL for CUDA, gloo for the CPU. There is
no fallback from one to the other: if NCCL does not initialise, the run
fails.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    data: int
    model: int
    rank: int
    model_group: dist.ProcessGroup
    data_group: dist.ProcessGroup
    pod: int = 1
    order: np.ndarray | None = None   # (data, model) ranks within a pod
    pod_group: dist.ProcessGroup | None = None

    @functools.cached_property
    def pod_order(self) -> np.ndarray:
        """``(data, model)``: the rank, within its pod, of each logical
        coordinate."""
        if self.order is None:
            return np.arange(self.data * self.model).reshape(self.data, self.model)
        return self.order

    @functools.cached_property
    def _coords(self) -> tuple[int, int, int]:
        per_pod = self.data * self.model
        g, r = np.argwhere(self.pod_order == self.rank % per_pod)[0]
        return self.rank // per_pod, int(g), int(r)

    @property
    def pod_rank(self) -> int:
        return self._coords[0]

    @property
    def data_rank(self) -> int:
        return self._coords[1]

    @property
    def model_rank(self) -> int:
        return self._coords[2]

    @property
    def n_batch(self) -> int:
        """Ranks the batch is split over: ``pod x data``."""
        return self.pod * self.data

    @property
    def batch_rank(self) -> int:
        """This rank's block of the batch (pod-major)."""
        return self.pod_rank * self.data + self.data_rank

    def global_rank(self, data_rank: int, model_rank: int,
                    pod_rank: int | None = None) -> int:
        """The rank at a logical coordinate (default: this rank's pod)."""
        p = self.pod_rank if pod_rank is None else pod_rank
        return p * self.data * self.model + int(self.pod_order[data_rank, model_rank])

    @functools.cached_property
    def model_order(self) -> list[int] | None:
        """Group rank of each model index in the model group (None: equal)."""
        return _group_order([self.global_rank(self.data_rank, m)
                             for m in range(self.model)])

    @functools.cached_property
    def batch_order(self) -> list[int] | None:
        """Group rank of each batch index in the data group (None: equal)."""
        return _group_order([self.global_rank(d, self.model_rank, p)
                             for p in range(self.pod) for d in range(self.data)])


def _group_order(ranks: list[int]) -> list[int] | None:
    """The group rank ``new_group`` gives each of ``ranks`` (it sorts
    them); None when that is their position."""
    pos = [sorted(ranks).index(r) for r in ranks]
    return None if pos == list(range(len(ranks))) else pos


def backend_for(device: torch.device | str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device: torch.device, world_size: int, rank: int) -> None:
    """Initialise the default process group for ``device``'s backend. A
    world of one meets in an in-process store; larger worlds read
    ``env://`` (``torchrun`` sets it)."""
    kwargs = {"store": dist.HashStore()} if world_size == 1 else {"init_method": "env://"}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend_for(device), world_size=world_size, rank=rank, **kwargs)


def make_mesh(data: int, model: int, *, pod: int = 1, order=None,
              timeout: datetime.timedelta | None = None) -> Mesh:
    """The ``[pod x] data x model`` mesh over the initialised world.
    ``order`` is a ``(data, model)`` array of the ranks within a pod that
    hold each logical coordinate (default row-major). Every rank creates
    every group, in the same order (``new_group`` is collective):
    the model groups, the data groups, then (``pod > 1``) the pod groups.
    ``timeout`` bounds each collective of the groups (default: the
    backend's), so a rank that skips one fails its peers instead of
    hanging them."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: torch.distributed is not initialised (call "
            "init_distributed or dist.init_process_group first)"
        )
    world = dist.get_world_size()
    if pod * data * model != world:
        shape = f"{pod}x{data}x{model}" if pod > 1 else f"{data}x{model}"
        raise ValueError(f"mesh {shape} needs {pod * data * model} ranks, the world has {world}")
    per_pod = data * model
    if order is not None:
        order = np.asarray(order, dtype=np.int64)
        if order.shape != (data, model) or sorted(order.ravel()) != list(range(per_pod)):
            raise ValueError(
                f"order must be a ({data}, {model}) permutation of the "
                f"{per_pod} ranks of a pod, got {order.tolist()}"
            )
    layout = order if order is not None else np.arange(per_pod).reshape(data, model)
    at = layout[None] + per_pod * np.arange(pod)[:, None, None]     # (pod, data, model)
    rank = dist.get_rank()
    mine = tuple(int(i) for i in np.argwhere(at == rank)[0])

    def groups(members, key):
        found = None
        for idx, ranks in members:
            g = dist.new_group([int(r) for r in ranks], timeout=timeout)
            if key(idx):
                found = g
        return found

    model_group = groups((((p, d), at[p, d]) for p in range(pod) for d in range(data)),
                         lambda i: i == mine[:2])
    data_group = groups(((m, at[:, :, m].ravel()) for m in range(model)),
                        lambda i: i == mine[2])
    pod_group = None
    if pod > 1:
        pod_group = groups((((d, m), at[:, d, m]) for d in range(data) for m in range(model)),
                           lambda i: i == mine[1:])
    return Mesh(data, model, rank, model_group, data_group, pod, order, pod_group)


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"DxM"`` -> ``(D, M)``."""
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: want DxM, e.g. 2x2") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec!r}: both sizes must be >= 1")
    return d, m
