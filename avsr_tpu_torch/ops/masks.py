"""Mask and label-layout utilities (counterpart of ``avsr_tpu/ops/masks.py``).

Padded (B, L) int tensors with explicit lengths, as in the JAX package:
  - make_non_pad_mask            (reference nets_utils.py:64)
  - subsequent_mask / target_mask (reference transformer/mask.py:20,41)
  - add_sos_eos                  (reference transformer/add_sos_eos.py:12)
"""

from __future__ import annotations

import torch

IGNORE_ID = -1


def make_non_pad_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B,) lengths -> (B, maxlen) bool, True on valid positions."""
    return torch.arange(maxlen, device=lengths.device)[None, :] < lengths[:, None]


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """(size, size) lower-triangular bool causal mask."""
    return torch.ones(size, size, dtype=torch.bool, device=device).tril()


def target_mask(ys_in_pad: torch.Tensor,
                ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """Decoder self-attention mask: (B, L, L) = non-pad & causal."""
    ys_mask = ys_in_pad != ignore_id
    causal = subsequent_mask(ys_in_pad.shape[-1], ys_in_pad.device)
    return ys_mask[:, None, :] & causal[None]


def add_sos_eos(ys_pad: torch.Tensor, ys_lengths: torch.Tensor, sos: int,
                eos: int, ignore_id: int = IGNORE_ID):
    """Decoder input and target layouts from padded labels.

    ys_pad: (B, L) labels padded with ignore_id; ys_lengths: (B,).
    Returns (ys_in, ys_out), each (B, L+1):
      ys_in  = [sos, y_1..y_n, eos, eos, ...]   (padded with eos)
      ys_out = [y_1..y_n, eos, ignore, ...]     (padded with ignore_id)
    """
    b, l = ys_pad.shape
    valid = ys_pad != ignore_id
    ys_in = torch.full((b, l + 1), eos, dtype=ys_pad.dtype,
                       device=ys_pad.device)
    ys_in[:, 0] = sos
    ys_in[:, 1:] = torch.where(valid, ys_pad, eos)
    pos = torch.arange(l + 1, device=ys_pad.device)[None, :]
    lens = ys_lengths[:, None]
    ys_clean = torch.nn.functional.pad(torch.where(valid, ys_pad, 0), (0, 1))
    ys_out = torch.where(pos < lens, ys_clean,
                         torch.where(pos == lens, eos, ignore_id))
    return ys_in, ys_out.to(ys_pad.dtype)
