"""Host->device wire codec for uint8 video crops (lossless, exact).

Counterpart of ``avsr_tpu/data/wire.py``, which cannot be imported without
JAX. The numpy encoders are copied from it (``wire.py:32-87``); the decoders
run on the device in torch. See that module for the codec's rationale:

  delta:  d[0] = v[0]; d[t] = (v[t] - v[t-1]) mod 256, decoded by a
          mod-256 cumulative sum over the frame axis;
  delta2: delta, then zigzag and nibble-plane packing (same byte count).
"""

from __future__ import annotations

import numpy as np
import torch

# normalisation of uint8 crops, avsr_tpu/data/transforms.py:21-22
VIDEO_MEAN = 0.421
VIDEO_STD = 0.165


def delta_encode_video(vid: np.ndarray, axis: int = -4) -> np.ndarray:
    """Temporal delta over the frame axis of uint8 crops (..., T, H, W, C).

    Wraparound uint8 subtraction; frame 0 is stored verbatim.
    """
    if vid.dtype != np.uint8:
        raise TypeError(f"delta wire codec is uint8-only, got {vid.dtype}")
    out = vid.copy()
    sl_hi = [slice(None)] * vid.ndim
    sl_lo = [slice(None)] * vid.ndim
    sl_hi[axis] = slice(1, None)
    sl_lo[axis] = slice(None, -1)
    out[tuple(sl_hi)] = vid[tuple(sl_hi)] - vid[tuple(sl_lo)]
    return out


def delta2_encode_video(vid: np.ndarray, axis: int = -4) -> np.ndarray:
    """delta -> zigzag -> nibble-plane pack. Lossless; W (axis -2) even."""
    d = delta_encode_video(vid, axis=axis)
    s = d.astype(np.int8).astype(np.int16)
    zz = ((s << 1) ^ (s >> 8)).astype(np.uint8)  # arithmetic >> keeps sign
    lo, hi = zz & 0x0F, zz >> 4
    # pair adjacent columns: first pixel in the high nibble of the packed byte
    packed_lo = (lo[..., ::2, :] << 4) | lo[..., 1::2, :]
    packed_hi = (hi[..., ::2, :] << 4) | hi[..., 1::2, :]
    return np.concatenate([packed_lo, packed_hi], axis=-2)


def delta_decode_video(delta: torch.Tensor, axis: int = -4) -> torch.Tensor:
    """Inverse of delta_encode_video: mod-256 cumulative sum (int32)."""
    acc = torch.cumsum(delta, dim=axis, dtype=torch.int32)
    return (acc % 256).to(torch.uint8)


def delta2_decode_video(packed: torch.Tensor, axis: int = -4) -> torch.Tensor:
    """Inverse of delta2_encode_video: planes -> un-zigzag -> cumsum."""
    w = packed.shape[-2] // 2
    plo, phi = packed[..., :w, :], packed[..., w:, :]
    lo = torch.stack([plo >> 4, plo & 0x0F], dim=-2)
    hi = torch.stack([phi >> 4, phi & 0x0F], dim=-2)
    zz = ((hi << 4) | lo).reshape(packed.shape)  # re-interleave columns
    # inverse zigzag in wraparound uint8: s = (zz >> 1) ^ (0 - (zz & 1))
    d = (zz >> 1) ^ (torch.zeros_like(zz) - (zz & 1))
    return delta_decode_video(d, axis=axis)
