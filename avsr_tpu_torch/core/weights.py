"""Weight bridge: JAX variables, released checkpoints and seeded weights.

The port's module names are the reference checkpoint's key names (the torch
side of ``core/checkpoint.avsr_mapping(cfg, prefix="")``, the port's copy of
the JAX package's mapping), so every source of weights ends in
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from avsr_tpu_torch.core.checkpoint import (
    _IGNORABLE_SUFFIXES,
    avsr_mapping,
    flax_to_torch,
    load_torch_state_dict,
    normalize_torch_keys,
)
from avsr_tpu_torch.core.config import AVHubertAVSRConfig


def torch_state_from_jax(variables_np, cfg: AVHubertAVSRConfig
                         ) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy or JAX arrays) -> the port's state dict."""
    state = flax_to_torch(variables_np, avsr_mapping(cfg, prefix=""))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in state.items()}


def load_released(model_dir: str, **overrides):
    """(cfg, AVSRModel) from an HF-style directory: ``config.json`` plus
    ``model.safetensors`` or ``pytorch_model.bin`` with ``avsr.``-prefixed
    keys, loaded strictly. ``overrides`` set top-level config fields (the
    decoder's dtypes, say) before the model is built."""
    from avsr_tpu_torch.models.e2e import AVSRModel

    cfg_path = os.path.join(model_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = AVHubertAVSRConfig.from_dict(json.load(f))
    else:
        cfg = AVHubertAVSRConfig()
    cfg = dataclasses.replace(cfg, **overrides)
    model = AVSRModel(cfg)
    load_state_file(model, model_dir, prefix="avsr.")
    return cfg, model


def load_state_file(model: nn.Module, path: str, prefix: str = "") -> None:
    """Load a released state dict (``load_torch_state_dict``: a .pth/.bin,
    a safetensors file or a directory holding one) into ``model`` strictly:
    keys lose ``prefix``; the suffixes the JAX package's converter ignores
    (``num_batches_tracked``...) are dropped; any other key left unused, or
    any of the model's left unset, raises."""
    state = {}
    for k, v in normalize_torch_keys(load_torch_state_dict(path)).items():
        if k.endswith(_IGNORABLE_SUFFIXES):
            continue
        state[k.removeprefix(prefix)] = torch.from_numpy(
            np.array(v, dtype=np.float32))
    model.load_state_dict(state, strict=True)


def _randn(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights (the JAX package's initialiser families):
    lecun-normal linear/conv kernels and zero biases, N(0, 1/sqrt(D))
    embeddings, unit norms, PReLU 0.25, weight-norm v ~ N(0, 0.02) and
    g = 1, BN statistics (0, 1), the conformer's rel-pos biases
    xavier-uniform. Draws come from ``generator``, on the generator's
    device, then move to the parameter's device."""
    from avsr_tpu_torch.models.avhubert import _WeightNormConv1d
    from avsr_tpu_torch.models.conformer import RelPositionAttention
    from avsr_tpu_torch.models.resnet import BatchNorm

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            w = mod.weight
            w.copy_(_randn(w.shape, 1.0 / math.sqrt(w[0].numel()), generator))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            w = mod.weight
            w.copy_(_randn(w.shape, 1.0 / math.sqrt(w.shape[1]), generator))
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
        elif isinstance(mod, _WeightNormConv1d):
            mod.weight_v.copy_(_randn(mod.weight_v.shape, 0.02, generator))
            mod.weight_g.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, RelPositionAttention):
            for w in (mod.pos_bias_u, mod.pos_bias_v):
                limit = math.sqrt(6.0 / sum(w.shape))
                w.copy_((torch.rand(w.shape, generator=generator,
                                    device=generator.device) * 2 - 1) * limit)
    return model
