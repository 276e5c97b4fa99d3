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
:func:`all_gather_dim` (JAX's tiled ``all_gather``); both run outside the
kernels, on the tensors the kernels return. On a tensor of the ``meta``
device (the planner's step, ``tools/plan.py``, which runs one rank's
forward with no data and no group) each returns the result's shape and
dtype and calls no group, as JAX compiles a sharded step on an abstract
mesh: a meta tensor has nothing to move. A real tensor never takes that
branch. The point-to-point half is
:func:`ppermute` (JAX's ``lax.ppermute``, the ring of context
parallelism), :func:`send` / :func:`recv` (a pipeline stage's activations
to the next stage's rank) and :func:`broadcast` (one rank's tensor to an
axis). Gloo documents no send or receive of a CUDA tensor, and NCCL
refuses two ranks on one card, so by the same open rule as
:func:`default_backend` a CUDA tensor on a gloo group is staged through
host memory and NCCL moves it on the device (:func:`via_host`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "DEFAULT_TIMEOUT_S",
    "all_gather_dim",
    "all_gather_last",
    "all_reduce",
    "broadcast",
    "broadcast_object",
    "broadcast_tensors",
    "capturable",
    "default_backend",
    "global_mesh",
    "initialize",
    "is_multi_host",
    "local_device",
    "ppermute",
    "recv",
    "send",
    "via_host",
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
    A meta tensor is its own sum (no data, no group).
    """
    if x.is_meta:
        return x
    dist.all_reduce(x, group=tp.group)
    return x


def all_gather_dim(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The axis's ``x`` concatenated on ``dim``, rank order (JAX's
    ``all_gather(..., tiled=True)``). ``dist.all_gather`` into a list: the
    call both torch versions the port runs on have, on both backends. A
    meta tensor gives the gathered shape (no data, no group)."""
    if x.is_meta:
        return torch.cat([x] * axis.size, dim=dim)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


def all_gather_last(x: torch.Tensor, tp) -> torch.Tensor:
    """The model axis's ``x`` concatenated on the last dim, rank order."""
    return all_gather_dim(x, tp, -1)


# ------------------------------------------------------- point to point


def via_host(x: torch.Tensor, group=None) -> bool:
    """Whether ``x`` crosses ``group`` through host memory: a CUDA tensor
    on a gloo group (gloo documents no send or receive of one)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


class Pending:
    """Sends and receives in flight: :meth:`wait` ends them, then copies
    each host-staged receive onto its device tensor. The host copies of
    staged sends live here until then."""

    def __init__(self, works, staged_sends, staged_recvs):
        self.works = works
        self.staged_sends = staged_sends
        self.staged_recvs = staged_recvs  # (host buffer, device tensor)

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        for host, out in self.staged_recvs:
            out.copy_(host)
        self.works, self.staged_sends, self.staged_recvs = [], [], []


def _post(ops, group) -> Pending:
    """Post ``ops`` ((isend or irecv, tensor, global peer rank, tag), ...;
    a send and its receive carry one tag) together: one
    ``batch_isend_irecv`` on NCCL, so that a ring of sends cannot
    deadlock; each on its own on gloo, whose sends and receives
    are asynchronous already. Every tensor is staged through the host
    where :func:`via_host` says so."""
    staged_sends, staged_recvs, posted = [], [], []
    for fn, t, peer, tag in ops:
        if via_host(t, group):
            if fn is dist.isend:
                t = t.cpu()
                staged_sends.append(t)
            else:
                host = torch.empty(t.shape, dtype=t.dtype)
                staged_recvs.append((host, t))
                t = host
        posted.append((fn, t, peer, tag))
    if dist.get_backend(group) == "nccl":
        works = dist.batch_isend_irecv([
            dist.P2POp(fn, t, peer, group, tag) for fn, t, peer, tag in posted
        ])
    else:
        works = [fn(t, peer, group=group, tag=tag)
                 for fn, t, peer, tag in posted]
    return Pending(works, staged_sends, staged_recvs)


def send(x: torch.Tensor, peer: int, group=None) -> Pending:
    """Start sending ``x`` to global rank ``peer``; ``wait()`` the result
    before ``x`` is written again."""
    return _post([(dist.isend, x.contiguous(), peer, 0)], group)


def recv(out: torch.Tensor, peer: int, group=None) -> torch.Tensor:
    """Receive into ``out`` from global rank ``peer``; returns it."""
    _post([(dist.irecv, out, peer, 0)], group).wait()
    return out


def ppermute(xs, axis, perm):
    """JAX's ``lax.ppermute`` over ``axis`` (a ``mesh.TPAxis``): each
    tensor of ``xs`` goes from axis index ``i`` to ``j`` for every ``(i,
    j)`` of ``perm``, all sends and receives posted together. A rank that
    no pair sends to gets zeros, as in JAX. Returns the received tensors,
    one for each of ``xs``."""
    me = axis.rank
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    outs = [torch.zeros_like(x) for x in xs]
    ops = []
    for tag, (x, out) in enumerate(zip(xs, outs)):
        if dst:
            ops.append((dist.isend, x.contiguous(),
                        dist.get_global_rank(axis.group, dst[0]), tag))
        if src:
            ops.append((dist.irecv, out,
                        dist.get_global_rank(axis.group, src[0]), tag))
    _post(ops, axis.group).wait()
    return outs


def broadcast(x: torch.Tensor, axis, src: int) -> torch.Tensor:
    """``x`` of axis index ``src`` on every rank of ``axis``, in place
    (staged through the host as :func:`via_host` says); returns it."""
    peer = dist.get_global_rank(axis.group, src)
    if via_host(x, axis.group):
        host = x.cpu()
        dist.broadcast(host, src=peer, group=axis.group)
        return x.copy_(host)
    dist.broadcast(x, src=peer, group=axis.group)
    return x


def broadcast_object(obj, src: int = 0):
    """A picklable ``obj`` of global rank ``src`` on every rank of the job
    (the default group); the other ranks pass anything, and every rank
    gets ``src``'s object back."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_tensors(tensors: Optional[dict], device,
                      src: int = 0) -> dict:
    """``tensors`` ({name: tensor}) of global rank ``src`` on every rank of
    the job, on ``device``: one header (names, dtypes, shapes) and the
    bytes of all of them in one buffer, which crosses the default group
    as :func:`broadcast` moves a tensor. The other ranks pass None. Every
    rank, ``src`` too, gets its tensors from the buffer, so all hold the
    same bytes."""
    from vptq_tpu_torch.parallel.mesh import TPAxis

    me = dist.get_rank()
    header = broadcast_object(None if me != src else [
        (k, str(t.dtype).removeprefix("torch."), tuple(t.shape))
        for k, t in tensors.items()], src)
    sizes = [torch.empty((), dtype=getattr(torch, d)).element_size()
             * torch.Size(shape).numel() for _, d, shape in header]
    if me == src and tensors:
        buf = torch.cat([t.detach().contiguous().reshape(-1)
                         .view(torch.uint8).to(device)
                         for t in tensors.values()])
    else:
        buf = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    broadcast(buf, TPAxis(dist.group.WORLD, dist.get_world_size(), me), src)
    out, off = {}, 0
    for (name, d, shape), n in zip(header, sizes):
        out[name] = buf[off: off + n].clone().view(
            getattr(torch, d)).reshape(shape)
        off += n
    return out
