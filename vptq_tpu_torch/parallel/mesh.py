"""The ranks' data × model layout: the role of ``make_mesh`` in
``vptq_tpu/parallel/sharding.py:50-62``.

JAX's mesh is an array of devices that one process drives. Here a
:class:`Mesh` is what one rank knows of the layout: the axis sizes, its
own coordinates, the process groups of its model axis (tensor
parallelism: the ranks that hold one model between them) and of its
data axis (the ranks that hold the same shard and split the batch), and
its device. Rank ``r`` sits at data ``r // model``, model ``r % model``:
the model axis innermost, as in the JAX package.

GSPMD's placement (``sharding.py`` ``shard_model``, ``shard_block``,
``shard_cache``, ``replicated``) has no counterpart: a rank's modules are
its shard (``parallel/tp.py``), the codebook format's too, which only
GSPMD partitions in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "TPAxis", "make_mesh"]


@dataclasses.dataclass(frozen=True)
class TPAxis:
    """An axis of the mesh as ``models.llama.forward`` sees it (JAX's
    ``tp=(axis_name, size)``, and ``cp=`` for the data axis): the group
    its collectives run over, its size and this rank's index along it."""

    group: Any
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int
    rank: int = 0  # this rank in the job
    device: torch.device = torch.device("cpu")
    model_group: Any = None  # the ranks of this rank's model axis
    data_group: Any = None  # the ranks of this rank's data axis

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def tp(self) -> TPAxis:
        return TPAxis(self.model_group, self.model, self.model_rank)

    @property
    def cp(self) -> TPAxis:
        """The data axis, over which a context-parallel prefill splits the
        prompt (JAX's ``cp_axis="data"``)."""
        return TPAxis(self.data_group, self.data, self.data_rank)


def make_mesh(
    data: int = 1, model: Optional[int] = None, device=None
) -> Mesh:
    """This rank's :class:`Mesh` over every rank of the default group
    (every rank calls it with the same arguments: each axis group is made
    by ``dist.new_group`` on every rank, in one order). ``device`` None:
    ``distributed.local_device()``, which raises without CUDA."""
    from vptq_tpu_torch.parallel.distributed import local_device

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized process group "
            "(vptq_tpu_torch.parallel.distributed.initialize)"
        )
    # the device first: a rank without its device fails before it joins
    # the collective group creation below
    device = torch.device(device) if device is not None else local_device()
    world, rank = dist.get_world_size(), dist.get_rank()
    if model is None:
        model = world // data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} devices")
    model_group = data_group = None
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    return Mesh(
        data=data, model=model, rank=rank,
        device=device,
        model_group=model_group, data_group=data_group,
    )
