"""Mask utilities (counterpart of ``avsr_tpu/ops/masks.py``)."""

from __future__ import annotations

import torch


def make_non_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B,) lengths -> (B, maxlen) bool, True on valid positions."""
    return torch.arange(maxlen, device=lengths.device)[None, :] < lengths[:, None]
