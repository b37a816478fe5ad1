"""Data and tensor parallelism over ``torch.distributed``.

What ``avsr_tpu/core/mesh.py`` gives the JAX package over a (data, model)
mesh, for one process a card: the process group from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; NCCL on ``cuda``, ``gloo`` on the CPU), laid out as
``make_mesh``'s ``reshape(data, model)``: rank ``d * model + m`` is model
rank ``m`` of data rank ``d``, so the ranks of one model group are
consecutive. Each rank has one data group (the ranks that hold the same
slice of the parameters, each with its own shard of the batch) and one
model group (the ranks that hold one shard of the batch, each with its
slice of the tensor-parallel parameters, ``core/tensor_parallel.py``).

The collectives that keep a step equal to the JAX package's global step,
each over one axis (``"data"`` by default, or ``"model"``):

- gradients: the mean over the data group, all-reduced once a step
  (``all_reduce_mean_``, one flat buffer);
- the batch over the model group: its first rank's, broadcast once a
  step (``broadcast_``), since a collator that draws from state of its
  own process (an interferer pool refreshed on a thread) gives the ranks
  of one model group different batches from the same samples;
- BatchNorm batch statistics over the global batch: ``all_reduce_sum``
  is a differentiable sum (its backward sums the cotangents), so the
  statistics' gradients reach every rank's inputs as under pjit. A model
  group holds one batch ``model`` times, so these never span it.

With one process (``world_size() == 1``) nothing here makes a process
group or a collective.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist

AXES = ("data", "model")

# axis -> (size, this rank's index on it, its process group); a group of
# None is the whole world, and an axis of size 1 has none
_layout: Dict[str, Tuple[int, int, Optional[object]]] = {}


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def _axis(axis: str) -> Tuple[int, int, Optional[object]]:
    if axis not in AXES:
        raise ValueError(f"axis must be one of {AXES}, got {axis!r}")
    return _layout.get(axis, (world_size(), rank(), None) if axis == "data"
                       else (1, 0, None))


def data_size() -> int:
    return _axis("data")[0]


def data_rank() -> int:
    return _axis("data")[1]


def model_size() -> int:
    return _axis("model")[0]


def model_rank() -> int:
    return _axis("model")[1]


def init(device: str = "cuda", data_parallel: Optional[int] = None,
         model_parallel: int = 1) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment (a
    single process when it describes none; a process group that exists
    already is used as it is), lay the world out as ``data_parallel`` x
    ``model_parallel`` (``set_layout``) and return this rank's device:
    ``cuda:LOCAL_RANK`` on the card, the CPU otherwise."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world > 1 and not tdist.is_initialized():
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        tdist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
            timeout=datetime.timedelta(minutes=10), **kw)
    set_layout(data_parallel, model_parallel)
    return dev


def set_layout(data_parallel: Optional[int] = None,
               model_parallel: int = 1) -> None:
    """Make the data and model groups of a ``data_parallel`` x
    ``model_parallel`` layout (``data_parallel`` defaults to the world
    over ``model_parallel``); every rank calls it alike. Raises unless
    the product is the world size."""
    world = world_size()
    model = int(model_parallel)
    data = world // max(model, 1) if data_parallel is None else int(
        data_parallel)
    if model < 1 or data < 1 or data * model != world:
        raise ValueError(f"data_parallel={data} x model_parallel={model} "
                         f"does not cover the world's {world} processes "
                         f"(one a card)")
    me = rank()
    _layout.clear()
    for axis, size, members in (
            ("data", data, [[d * model + m for d in range(data)]
                            for m in range(model)]),
            ("model", model, [[d * model + m for m in range(model)]
                              for d in range(data)])):
        mine = None
        for ranks in members:
            # every rank makes every group, in one order (new_group's rule)
            g = (None if size == world else tdist.new_group(ranks)
                 if size > 1 else None)
            if me in ranks:
                mine = (size, ranks.index(me), g)
        _layout[axis] = mine


def close() -> None:
    _layout.clear()
    if tdist.is_initialized():
        tdist.destroy_process_group()


def all_reduce_(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Sum ``x`` in place over the ranks of ``axis`` and return it."""
    size, _, g = _axis(axis)
    if size > 1:
        tdist.all_reduce(x, group=g)
    return x


def broadcast_(tensors: List[torch.Tensor], axis: str = "model") -> None:
    """Replace each tensor in place by the first rank of ``axis``'s (every
    rank passes tensors of the same shapes). Nothing happens on an axis of
    one rank."""
    size, _, g = _axis(axis)
    if size == 1:
        return
    src = 0 if g is None else tdist.get_global_rank(g, 0)
    for t in tensors:
        tdist.broadcast(t, src=src, group=g)


def all_reduce_mean_(tensors: List[torch.Tensor], axis: str = "data") -> None:
    """Replace each tensor in place by its mean over the ranks of ``axis``,
    in one collective over a flat fp32 buffer. Nothing happens on an axis
    of one rank."""
    size = _axis(axis)[0]
    if size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_(flat, axis)
    flat.div_(size)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


def all_reduce_sum(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, differentiable: the
    backward sums the ranks' cotangents, so each rank's input gets the
    gradient of the sum of every rank's loss (SyncBatchNorm's rule). ``x``
    itself on an axis of one rank."""
    if _axis(axis)[0] == 1:
        return x
    return _AllReduceSum.apply(x, axis)
