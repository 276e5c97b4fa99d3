"""The process group, and the two collectives of the sharded forward.

Port of ``vptq_tpu/parallel/distributed.py``. JAX runs one process that
drives every device; here each rank is a process of its own
(``torchrun``, or ``torch.multiprocessing.spawn`` in the tests and the
smoke), joined by ``torch.distributed``:

    torchrun --nproc-per-node 2 -m vptq_tpu_torch --model DIR --tp 2 ...

The backend is chosen in the open (:func:`default_backend`): NCCL when
every rank owns a card of its own, gloo on the CPU or when ranks share
one card (NCCL refuses two ranks on one device). A caller that asks for
NCCL on a shared card gets NCCL's own error. The group gets a finite
timeout, so that a rank that stops answering fails the others' next
collective instead of hanging them.

The forward's collectives are :func:`all_reduce` (JAX's ``psum``) and
:func:`all_gather_last` (JAX's tiled ``all_gather`` on the last axis);
both run outside the kernels, on the tensors the kernels return.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "DEFAULT_TIMEOUT_S",
    "all_gather_last",
    "all_reduce",
    "capturable",
    "default_backend",
    "global_mesh",
    "initialize",
    "is_multi_host",
    "local_device",
]

# long enough for a rank that builds a kernel library or encodes a block
# while the others wait in a collective, short enough that a hang fails
DEFAULT_TIMEOUT_S = 600.0


def default_backend() -> str:
    """"nccl" when CUDA is present and every rank on this host can own a
    card of its own (``LOCAL_WORLD_SIZE`` ranks, as ``torchrun`` sets it,
    at most the cards visible), else "gloo"."""
    if not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get(
        "LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def local_device(backend: Optional[str] = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` under NCCL, ``cuda:0`` for
    every rank of a gloo group sharing one card. Without CUDA it raises:
    a rank runs on the CPU only when its caller passes ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU"
        )
    backend = backend or (dist.get_backend() if dist.is_initialized()
                          else default_backend())
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cuda", 0)


def initialize(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the default process group; safe to call twice (no-op).

    Given nothing, reads ``torchrun``'s environment: ``RANK``,
    ``WORLD_SIZE`` and the rendezvous at ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``env://``). ``backend`` None: :func:`default_backend`.
    """
    if dist.is_initialized():
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError(
                "no init_method given and no MASTER_ADDR / MASTER_PORT in "
                "the environment: launch under torchrun or pass "
                "init_method (e.g. 'tcp://localhost:29500' or "
                "'file:///path/to/store')"
            )
        init_method = "env://"
    backend = backend or default_backend()
    kwargs = {}
    if backend == "nccl":
        # binds the group to this rank's card (and warns of nothing later)
        kwargs["device_id"] = local_device("nccl")
        torch.cuda.set_device(kwargs["device_id"])
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
    )


def is_multi_host() -> bool:
    """More ranks in the job than ``torchrun`` started on this host."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", str(world))) < world


def global_mesh(data: int = 1, model: Optional[int] = None, device=None):
    """The mesh over every rank of the job (every rank calls this with
    the same arguments); the model axis innermost, as in the JAX
    package, so that a tensor-parallel group is the ranks of one host."""
    from vptq_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(data=data, model=model, device=device)


def capturable(group) -> bool:
    """Whether a CUDA graph can hold this group's collectives: NCCL's can
    (after one eager step), gloo's run on the host and cannot."""
    return dist.get_backend(group) == "nccl"


def all_reduce(x: torch.Tensor, tp) -> torch.Tensor:
    """Sum ``x`` over the model axis (JAX's ``psum``), in place; returns it.

    One ``dist.all_reduce`` in ``x``'s own dtype (the activation dtype, as
    JAX's ``psum`` reduces). Above two ranks the backend's order of the
    sum is its own (a ring adds in another order in each chunk), so the
    bits may differ from the JAX package's by the rounding of that order.
    """
    dist.all_reduce(x, group=tp.group)
    return x


def all_gather_last(x: torch.Tensor, tp) -> torch.Tensor:
    """The model axis's ``x`` concatenated on the last dim, rank order
    (JAX's ``all_gather(..., tiled=True)``). ``dist.all_gather`` into a
    list: the call both torch versions the port runs on have, on both
    backends."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return torch.cat(parts, dim=-1)
