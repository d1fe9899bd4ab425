"""Data parallelism over a ``torch.distributed`` process group (counterpart
of ``text2speech_tpu/parallel/mesh.py``).

Under jit the JAX package shards the batch axis over a ``'data'`` mesh
axis and XLA inserts the collectives.  The port does the same work
explicitly: one process per rank, every rank holding the whole model and
its own contiguous block of the global batch's rows, and the collectives
written out where the sums cross ranks (the trainers' one gradient
all-reduce a step, BatchNorm's statistics, the row gathers of
``infer_long`` and the TP vocoder).  NCCL carries them between cards; gloo
on the CPU and on a card that several local ranks share.

Every collective here is an ``all_reduce`` or a ``broadcast``: gloo carries
both for CUDA tensors, not every other one.  A row (or column) gather is an
``all_reduce`` of a zeroed buffer into which each rank wrote its rows (or
columns), which is exact (every sum adds zeros to one value).

A :class:`Mesh` names its axes, their sizes, this process's index on each
and the process group of each axis.  :func:`make_mesh` builds the groups;
every rank creates every group in the same order, as ``new_group``
requires.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import count

DATA_AXIS = "data"
MODEL_AXIS = "model"

# what initialize_distributed chose: {"backend": str, "device": device}
_RUNTIME: dict = {}


def choose_backend(device_type: str, local_world_size: int,
                   device_count: int) -> str:
    """``nccl`` when every local rank has a card of its own; ``gloo`` on
    the CPU and when several local ranks share a card (NCCL refuses two
    ranks on one device)."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if local_world_size <= device_count else "gloo"


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None, **kwargs) -> bool:
    """Join the process group; True when the run is (or already was)
    distributed, False for a plain single-process run.

    It initializes when an address is given (``init_method``, e.g.
    ``tcp://localhost:29500``) or when torchrun's environment says
    ``WORLD_SIZE`` > 1; tuning kwargs alone do not start it, and a second
    call is a no-op.  ``world_size`` and ``rank`` default to torchrun's
    ``WORLD_SIZE`` / ``RANK``.

    ``device`` (a keyword of its own: ``"cuda"`` or ``"cpu"``; default the
    card when one is visible).  The local rank and the number of local
    ranks are torchrun's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, else
    ``rank`` / ``world_size`` (one host).  A rank's device is
    ``cuda:local_rank % device_count``; the backend is
    :func:`choose_backend`'s.  Asked for the card without one, it raises:
    nothing falls back to the CPU.  The other kwargs go to
    ``init_process_group`` (``timeout``, ...)."""
    device = kwargs.pop("device", None)
    if dist.is_initialized():
        return True
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if init_method is None and env_world <= 1:
        return False
    world_size = env_world if world_size is None else int(world_size)
    rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dtype = torch.device(device).type
    n_cards = 0
    if dtype == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda'): no "
                               "CUDA device is visible")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    elif dtype == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    backend = choose_backend(dtype, local_world_size, n_cards)
    init_kw = dict(backend=backend, world_size=world_size, rank=rank,
                   **kwargs)
    if init_method is not None:
        init_kw["init_method"] = init_method
    if backend == "nccl":
        init_kw["device_id"] = dev      # this rank's card, not a guess
    dist.init_process_group(**init_kw)
    _RUNTIME.update(backend=backend, device=dev)
    return True


def rank_device() -> torch.device:
    """This rank's device: the one :func:`initialize_distributed` chose,
    else the current card under NCCL, else the CPU."""
    if "device" in _RUNTIME:
        return _RUNTIME["device"]
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def distributed_banner() -> str:
    """``distributed: process r/n (backend, device)``, as the root CLIs
    print it."""
    return (f"distributed: process {dist.get_rank()}/"
            f"{dist.get_world_size()} ({dist.get_backend()}, "
            f"{rank_device()})")


def destroy_distributed() -> None:
    """Wait for every rank, then leave the group (the barrier keeps rank 0,
    which hosts the TCP store, from going while another still uses it)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _RUNTIME.clear()


@dataclass(frozen=True)
class Mesh:
    """Ranks ``0 .. prod(shape) - 1`` of the world laid out row-major on
    the named axes, with this process's place on them.  ``coords`` is None
    on a rank outside the mesh (the world is larger than the mesh)."""

    axis_names: tuple
    shape: tuple
    groups: tuple          # per axis: this rank's group along it, or None
    coords: tuple | None
    device: torch.device
    world_size: int = 1

    @property
    def member(self) -> bool:
        return self.coords is not None

    def size(self, axis: str = DATA_AXIS) -> int:
        """The axis' size; 1 for an axis the mesh does not have."""
        if axis not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(axis)]

    def rank(self, axis: str = DATA_AXIS) -> int:
        """This process's index on the axis."""
        if axis not in self.axis_names:
            return 0
        if self.coords is None:
            raise ValueError(f"this rank is outside the {self.shape} mesh")
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str = DATA_AXIS):
        """The process group along the axis through this rank."""
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no {axis!r} axis")
        return self.groups[self.axis_names.index(axis)]


def make_mesh(shape: tuple | None = None,
              axis_names: tuple = (DATA_AXIS,),
              device: torch.device | None = None) -> Mesh:
    """A mesh over the first ``prod(shape)`` ranks of the initialized
    world (default: all of them on the first axis), e.g.
    ``make_mesh((2, 2), (DATA_AXIS, MODEL_AXIS))``.  Collective: every rank
    of the world calls it, inside the mesh or not, and creates every
    group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed group: call "
                           "initialize_distributed first")
    world, me = dist.get_world_size(), dist.get_rank()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} for axes {axis_names}")
    n = math.prod(shape)
    if n < 1 or n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{world}")
    grid = np.arange(n).reshape(shape)
    groups = [None] * len(shape)
    for ax in range(len(shape)):
        # the lines of the grid along this axis, in the same order on every
        # rank
        for line in np.moveaxis(grid, ax, -1).reshape(-1, shape[ax]):
            members = [int(r) for r in line]
            g = (dist.group.WORLD if len(members) == world
                 else dist.new_group(members))
            if me in members:
                groups[ax] = g
    coords = (tuple(int(c) for c in np.unravel_index(me, shape))
              if me < n else None)
    return Mesh(tuple(axis_names), shape, tuple(groups), coords,
                device if device is not None else rank_device(), world)


def data_mesh_size(batch_size: int, world_size: int) -> int:
    """The most ranks, at most ``world_size``, that evenly divide
    ``batch_size`` (``mesh.py:82-90``)."""
    n = world_size
    while n > 1 and batch_size % n != 0:
        n -= 1
    return n


def make_data_mesh(batch_size: int) -> Mesh:
    """A data mesh over the most ranks that evenly divide ``batch_size``
    (a 2-utterance debug batch on 8 ranks must not crash).  The ranks past
    it are outside the mesh: :func:`require_member` refuses to train
    there."""
    return make_mesh((data_mesh_size(batch_size, dist.get_world_size()),))


def default_data_mesh(batch_size: int) -> Mesh | None:
    """The trainers' default: :func:`make_data_mesh` once the process group
    is up (:func:`initialize_distributed`), else None (one process)."""
    if dist.is_available() and dist.is_initialized():
        return make_data_mesh(batch_size)
    return None


def trainer_device(mesh: Mesh | None, device) -> torch.device:
    """The device a trainer runs on: ``device``, or with a mesh the mesh's
    device, which must be of the type asked for."""
    device = torch.device(device)
    if mesh is None:
        return device
    if mesh.device.type != device.type:
        raise ValueError(f"the trainer was asked for {device.type} but the "
                         f"mesh's ranks run on {mesh.device}")
    return mesh.device


def require_member(mesh: Mesh, batch_size: int) -> None:
    """Raise on a rank outside ``mesh``, naming the batch and the world."""
    if not mesh.member:
        raise ValueError(
            f"rank {dist.get_rank()} is outside the data mesh: batch "
            f"{batch_size} divides over {mesh.size()} of the "
            f"{mesh.world_size} ranks; choose a batch size that the world "
            f"size divides, or start {mesh.size()} ranks")


def _map(fn, tree):
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def row_block(n_rows: int, mesh: Mesh, axis: str = DATA_AXIS) -> slice:
    """This rank's contiguous block of ``n_rows`` rows."""
    n = mesh.size(axis)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not split over {n} ranks of "
                         f"the {axis!r} axis")
    k = n_rows // n
    r = mesh.rank(axis)
    return slice(r * k, (r + 1) * k)


def shard_batch(batch: Any, mesh: Mesh, axis: str = DATA_AXIS) -> Any:
    """This rank's contiguous row block of every leaf of the ALREADY
    PADDED global batch (a tensor, an array, or tuples, named tuples,
    lists and dicts of them), on the mesh's device (replaces
    DistributedSampler + ``to_gpu``; ``mesh.py:101``).  Every rank passes
    the same global batch."""
    def take(x):
        x = torch.as_tensor(x)
        return x[row_block(x.shape[0], mesh, axis)].to(mesh.device)

    return _map(take, batch)


def _tensors(obj) -> list:
    from ..train.state import TrainState

    if isinstance(obj, torch.nn.Module):
        return [t.data for t in obj.parameters()] + list(obj.buffers())
    if isinstance(obj, TrainState):
        return ([p.data for p in obj.params.values()]
                + list(obj.batch_stats.values())
                + [v for st in obj.opt.state.values() for v in st.values()
                   if torch.is_tensor(v)])
    out = []
    _map(out.append, obj)
    return [t for t in out if torch.is_tensor(t)]


def _coalesced(tensors: list, collective) -> None:
    """Run ``collective`` on one flat buffer per (device, dtype) and copy
    the result back.  Under NCCL a CPU tensor (Adam's step counter) makes
    the trip on the card."""
    nccl = dist.get_backend() == "nccl"
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    for (device, _), ts in buckets.items():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if nccl and device.type != "cuda":
            flat = flat.to(rank_device())
        collective(flat)
        flat = flat.to(device)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def replicate(obj: Any, mesh: Mesh, axis: str = DATA_AXIS) -> Any:
    """Broadcast every tensor of ``obj`` in place from the axis' first rank
    (replaces the rank-0 broadcast of ``waveglow/distributed.py:100-103``;
    ``mesh.py:108``).  ``obj``: a module (parameters and buffers), a
    :class:`..train.state.TrainState` (parameters, running statistics and
    the optimizer's state), or a tree of tensors.  Returns ``obj``."""
    group = mesh.group(axis)
    src = dist.get_global_rank(group, 0)
    _coalesced(_tensors(obj), lambda flat: dist.broadcast(flat, src,
                                                          group=group))
    return obj


def all_reduce_mean_(tensors: list, mesh: Mesh,
                     axis: str = DATA_AXIS) -> None:
    """Average ``tensors`` in place over the axis' ranks: one
    ``all_reduce`` per (device, dtype), then a division by the axis'
    size.  Counter ``train.allreduce_bytes``: each buffer's bytes."""
    group, n = mesh.group(axis), mesh.size(axis)

    def mean(flat):
        count("train.allreduce_bytes", flat.numel() * flat.element_size())
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _coalesced(tensors, mean)


def _exact_buffer(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a type every backend sums (f32 for the low-precision
    floats, int32 for bool): the cast and its inverse are exact."""
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    if x.is_floating_point() and x.dtype not in (torch.float32,
                                                 torch.float64):
        return x.to(torch.float32)
    return x


def gather_rows(x: torch.Tensor, mesh: Mesh,
                axis: str = DATA_AXIS) -> torch.Tensor:
    """The global tensor from every rank's contiguous row block ``x``:
    each rank writes its rows into a zeroed buffer, and an ``all_reduce``
    sums the buffers, which adds only zeros to each value.  The result
    keeps ``x``'s type (bool and bf16 travel as int32 and f32)."""
    n, r = mesh.size(axis), mesh.rank(axis)
    k = x.shape[0]
    buf = _exact_buffer(x)
    out = buf.new_zeros((n * k,) + tuple(x.shape[1:]))
    out[r * k:(r + 1) * k] = buf
    dist.all_reduce(out, group=mesh.group(axis))
    return out.to(x.dtype)


def gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """The [..., p k] tensor from every rank's block of k columns ``x``
    [..., k], in the order of the ranks of ``group``: as
    :func:`gather_rows`, a zeroed buffer and one ``all_reduce`` (the
    tensor-parallel decoder's hidden-state gather)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = x.shape[-1]
    buf = _exact_buffer(x)
    out = buf.new_zeros(tuple(x.shape[:-1]) + (n * k,))
    out[..., r * k:(r + 1) * k] = buf
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)
