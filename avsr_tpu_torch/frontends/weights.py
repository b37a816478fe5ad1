"""Flax variables of the JAX frontends -> the port's state dicts.

The port's frontend modules carry the reference checkpoints' parameter
names, the names the JAX package's converters read
(``retinaface_torch_to_flax``, ``s3fd_torch_to_flax``,
``fan_torch_to_flax``, ``asd_torch_to_flax``). Each family's
``*_flax_to_torch`` inverts its converter: it walks the port module's own
parameters and buffers, finds each one's flax path with the family's
naming rule, and undoes the converter's transform by the module's type.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from avsr_tpu_torch.models.resnet import BatchNorm

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}
_GATES = (("ir", "iz", "in"), ("hr", "hz", "hn"))


def _node(tree: dict, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def _lookup(tree: dict, path: Tuple[str, ...]) -> np.ndarray:
    return np.asarray(_node(tree, path), np.float32)


def _gru_leaf(node: dict, leaf: str) -> np.ndarray:
    """torch GRU rows [r, z, n] from a flax GRUCell. The converter folds the
    hidden-side r and z biases into the input side, so they come back as
    zeros, and the hidden n bias is ``hn``'s."""
    side = 0 if "_ih_" in leaf else 1
    if leaf.startswith("weight"):
        return np.concatenate([np.asarray(node[g]["kernel"], np.float32).T
                               for g in _GATES[side]])
    if side == 0:
        return np.concatenate([np.asarray(node[g]["bias"], np.float32)
                               for g in _GATES[0]])
    hn = np.asarray(node["hn"]["bias"], np.float32)
    return np.concatenate([np.zeros_like(hn), np.zeros_like(hn), hn])


def released_state(state: dict, skip_parts=()) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state dict (arrays or tensors) as fp32
    tensors, without the keys its JAX converter skips:
    ``num_batches_tracked`` and any key with a part in ``skip_parts``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in state.items()
            if not k.endswith("num_batches_tracked")
            and not set(skip_parts) & set(k.split("."))}


def state_from_flax(model: nn.Module, variables: dict,
                    flax_path: Callable[[str], Tuple[str, ...]]
                    ) -> Dict[str, torch.Tensor]:
    """``model``'s state dict from flax ``variables`` (nested dicts of
    arrays, ``params`` and ``batch_stats``); ``flax_path`` maps a torch
    module name to its flax path."""
    colls = {"params": variables["params"],
             "batch_stats": variables.get("batch_stats", {})}
    state = {}
    for name, mod in model.named_modules():
        leaves = [n for n, _ in itertools.chain(
            mod.named_parameters(recurse=False),
            mod.named_buffers(recurse=False))]
        if not leaves:
            continue
        path = flax_path(name)
        params = colls["params"]
        for leaf in leaves:
            if isinstance(mod, BatchNorm):
                coll, fleaf = _BN_LEAVES[leaf]
                arr = _lookup(colls[coll], path + (fleaf,))
            elif isinstance(mod, nn.GRU):
                arr = _gru_leaf(_node(params, path), leaf)
            elif isinstance(mod, (nn.Conv2d, nn.Conv3d)) and leaf == "weight":
                k = _lookup(params, path + ("kernel",))
                arr = np.transpose(k, (k.ndim - 1, k.ndim - 2)
                                   + tuple(range(k.ndim - 2)))
            elif isinstance(mod, nn.Linear) and leaf == "weight":
                arr = _lookup(params, path + ("kernel",)).T
            else:
                arr = _lookup(params, path + (leaf,))
            state[f"{name}.{leaf}"] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return state

