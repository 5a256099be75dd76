"""A ``("data", "model")`` mesh of ``torch.distributed`` ranks (PyTorch port
of ``repro.launch.mesh`` for the serving path).

Rank ``r`` sits at ``(r // model, r % model)``: the row-major order in
which ``make_mesh_compat`` lays host devices out, so the port's model
index equals the JAX ``axis_index("model")``. Each rank belongs to one
*model group* (the ranks of its data index: the EP all-to-all, the decode
ownership sum and the LSE merge run there) and one *data group* (the ranks
of its model index: the balancer's expert counts are summed there).

The backend follows the device: NCCL for CUDA, gloo for the CPU. There is
no fallback from one to the other: if NCCL does not initialise, the run
fails.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    data: int
    model: int
    rank: int
    model_group: dist.ProcessGroup
    data_group: dist.ProcessGroup

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def global_rank(self, data_rank: int, model_rank: int) -> int:
        return data_rank * self.model + model_rank


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


def make_mesh(data: int, model: int, timeout: datetime.timedelta | None = None) -> Mesh:
    """The ``data x model`` mesh over the initialised world. Every rank
    creates every group, in the same order (``new_group`` is collective).
    ``timeout`` bounds each collective of the groups (default: the
    backend's), so a rank that skips one fails its peers instead of
    hanging them."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: torch.distributed is not initialised (call "
            "init_distributed or dist.init_process_group first)"
        )
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, the world has {world}")
    rank = dist.get_rank()
    model_group = data_group = None
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)], timeout=timeout)
        if rank // model == d:
            model_group = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)], timeout=timeout)
        if rank % model == m:
            data_group = g
    return Mesh(data, model, rank, model_group, data_group)


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"DxM"`` -> ``(D, M)``."""
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: want DxM, e.g. 2x2") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec!r}: both sizes must be >= 1")
    return d, m
