"""Data parallelism over ``torch.distributed``.

What ``avsr_tpu/core/mesh.py`` gives the JAX package over a ('data',)
mesh, for one process a card: the process group from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; NCCL on ``cuda``, ``gloo`` on the CPU), and the
collectives that keep a data-parallel step equal to the JAX package's
global step over the sharded batch:

- gradients: the mean over ranks, all-reduced once a step
  (``all_reduce_mean_``, one flat buffer);
- BatchNorm batch statistics over the global batch: ``all_reduce_sum``
  is a differentiable sum (its backward sums the cotangents), so the
  statistics' gradients reach every rank's inputs as under pjit.

With one process (``world_size() == 1``) nothing here makes a process
group or a collective. Tensor parallelism (the JAX package's 'model'
axis) has no counterpart yet (ROADMAP A12).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as tdist


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def init(device: str = "cuda", data_parallel: Optional[int] = None,
         model_parallel: int = 1) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment
    (a single process when it describes none) and return this rank's
    device: ``cuda:LOCAL_RANK`` on the card, the CPU otherwise.
    ``data_parallel``, when given, must equal the world size."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor parallelism (the JAX "
            f"package's Megatron layout over a 'model' axis) is not ported "
            f"yet (ROADMAP A12); run data-parallel only")
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
    if data_parallel is not None and data_parallel != world_size():
        raise ValueError(f"data_parallel={data_parallel} but the world has "
                         f"{world_size()} processes (one a card)")
    return dev


def close() -> None:
    if tdist.is_initialized():
        tdist.destroy_process_group()


def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    """Replace each tensor in place by its mean over the ranks, in one
    collective over a flat fp32 buffer. Nothing happens on one rank."""
    if world_size() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    tdist.all_reduce(flat)
    flat.div_(world_size())
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        tdist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the backward sums
    the ranks' cotangents, so each rank's input gets the gradient of the
    sum of every rank's loss (SyncBatchNorm's rule). ``x`` itself on one
    rank."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x)
