"""Tensor parallelism: the JAX package's Megatron layout over the 'model'
axis (``avsr_tpu/core/mesh.py`` ``param_partition_spec``).

The rule on names, on torch's ``(out, in)`` weights: attention q/k/v and
the FFN up-projections split their output dimension (``COLUMN``: weight
dim 0), attention out-projections and the FFN down-projections their
input dimension (``ROW``: weight dim 1); everything else (norms, biases,
embeddings, convolutions, the CTC head, the decoder's output layer) is
replicated. ``partition_dim`` is that rule as JAX states it.

Where the port stores a slice: each rank of a model group of ``size``
keeps chunk ``rank`` of every split weight and, since its block computes
only its own output columns, of a column-split layer's bias too
(``shard_dim``); a row-split layer's bias stays whole and is added once,
after the sum over the group. So each rank runs ``heads / size``
attention heads and ``units / size`` FFN columns. Two autograd functions
carry Megatron's collectives (over ``core/dist``'s model group):
``copy_to_model`` at the input of every column-split block (identity
forward, sum backward: the replicated input's gradient is the sum of the
ranks' parts) and ``reduce_from_model`` after every row-split product
(sum forward, identity backward). The sums run in fp32.

The state dict a user sees and every checkpoint keep the full tensors
under the reference names (``full_state_dict``, ``gather_state_dict``;
``shard_state_dict`` slices them back), so a checkpoint written at one
model size loads at another. ``shard_model_`` slices a model in place,
through each block's ``shard_`` (the encoder's ``EncoderSelfAttention``
and ``FeedForward``, the decoder's ``MultiHeadAttention`` and
``DecoderLayer``); a split parameter whose block has none (the conformer
and AV2Text families) makes it raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.core import dist

COLUMN = frozenset({"q_proj", "k_proj", "v_proj", "intermediate_dense",
                    "linear_q", "linear_k", "linear_v", "w_1", "fc1"})
ROW = frozenset({"out_proj", "output_dense", "linear_out", "w_2", "fc2"})


def _owner_leaf(name: str):
    parts = name.split(".")
    return (parts[-2] if len(parts) >= 2 else ""), parts[-1]


def partition_dim(name: str, ndim: int) -> Optional[int]:
    """The dimension of parameter ``name`` that JAX's rule splits over the
    model axis, on torch's (out, in) layout; None: replicated."""
    owner, leaf = _owner_leaf(name)
    if leaf != "weight" or ndim < 2:
        return None
    if owner in COLUMN:
        return 0
    if owner in ROW:
        return 1
    return None


def shard_dim(name: str, ndim: int) -> Optional[int]:
    """The dimension along which a rank stores a slice of ``name``: the
    split weights', and a column-split layer's bias along its outputs."""
    owner, leaf = _owner_leaf(name)
    if leaf == "bias" and owner in COLUMN:
        return 0
    return partition_dim(name, ndim)


def chunk(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    if t.shape[dim] % size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split into {size}")
    return t.chunk(size, dim)[rank]


def shard_state_dict(sd: Dict[str, torch.Tensor], model_rank: int,
                     model_size: int) -> Dict[str, torch.Tensor]:
    """A full state dict's slices for ``model_rank`` of ``model_size``."""
    if model_size == 1:
        return dict(sd)
    out = {}
    for name, t in sd.items():
        d = shard_dim(name, t.dim())
        out[name] = t if d is None else chunk(t, d, model_rank,
                                              model_size).clone()
    return out


def gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The full tensor of which every rank of the model group holds chunk
    ``model_rank`` along ``dim``: each rank's chunk in place in zeros,
    summed over the group (only ``all_reduce``, which ``gloo`` runs on
    CUDA tensors too; adding zeros is exact)."""
    size, rank = dist.model_size(), dist.model_rank()
    shape = list(t.shape)
    shape[dim] *= size
    full = t.new_zeros(shape)
    full.narrow(dim, rank * t.shape[dim], t.shape[dim]).copy_(t)
    return dist.all_reduce_(full, "model")


def gather_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The full state dict of this model group's slices; a collective that
    every rank of the group calls."""
    if dist.model_size() == 1:
        return dict(sd)
    return {name: t if (d := shard_dim(name, t.dim())) is None
            else gather(t, d) for name, t in sd.items()}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every slice gathered: the reference
    names and shapes at any model size."""
    return gather_state_dict(model.state_dict())


def load_full_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]):
    """Load a full state dict, strictly, into a model sliced for this
    rank."""
    return model.load_state_dict(
        shard_state_dict(sd, dist.model_rank(), dist.model_size()))


def shard_linear_(lin: nn.Linear, dim: int, rank: int, size: int) -> None:
    """Keep chunk ``rank`` of ``lin``'s weight along ``dim`` (0: its
    outputs, with the bias; 1: its inputs, the bias whole)."""
    lin.weight = nn.Parameter(chunk(lin.weight.detach(), dim, rank,
                                    size).clone())
    if dim == 0:
        lin.out_features = lin.weight.shape[0]
        if lin.bias is not None:
            lin.bias = nn.Parameter(chunk(lin.bias.detach(), 0, rank,
                                          size).clone())
    else:
        lin.in_features = lin.weight.shape[1]
        lin.row_split = True


def shard_model_(model: nn.Module, rank: int, size: int) -> nn.Module:
    """Slice ``model`` in place for ``rank`` of a model group of ``size``
    (before its optimizer is made). Raises if a parameter that the rule
    splits belongs to a block without a tensor-parallel forward."""
    if size == 1:
        return model
    full = {n: p.shape for n, p in model.named_parameters()}
    for m in model.modules():
        if hasattr(m, "shard_"):
            m.shard_(rank, size)
    for name, p in model.named_parameters():
        d = shard_dim(name, p.dim())
        if d is not None and p.shape[d] * size != full[name][d]:
            raise NotImplementedError(
                f"{name}: its block has no tensor-parallel forward (only "
                f"the modules that cli/train.py builds are sharded)")
    return model


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum_fp32(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _sum_fp32(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model group, taken in fp32 and returned
    in x's dtype."""
    y = x.float().contiguous()
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    return dist.all_reduce_(y, "model").to(x.dtype)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-split block: x forward, the gradient summed
    over the model group backward."""
    return x if dist.model_size() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """A row-split product's partial sums summed over the model group
    forward; the gradient as it is backward."""
    return x if dist.model_size() == 1 else _ReduceFromModel.apply(x)


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)``; for a row-split layer the partial products summed over
    the model group, then the whole bias added once."""
    if not getattr(lin, "row_split", False):
        return lin(x)
    y = reduce_from_model(F.linear(x, lin.weight))
    return y if lin.bias is None else y + lin.bias
