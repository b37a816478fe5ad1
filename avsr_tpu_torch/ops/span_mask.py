"""Span masking for AV-HuBERT-style pretraining/fine-tuning augmentation.

The port's copy of ``avsr_tpu/ops/span_mask.py`` (numpy only;
``tests/test_torch_port_pretrain.py`` holds it equal to the original).
Host-side numpy equivalent of the reference compute_mask_indices
(backbones/avhubert.py:43-171, fairseq lineage): sample ~mask_prob*T/L span
starts per sequence (probabilistic rounding), expand to spans, trim to the
batch-minimum mask count so every row masks the same number of positions.
Supports the 'static' and 'uniform' span-length modes the configs use.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def compute_mask_indices(
    shape: Tuple[int, int],
    padding_mask: Optional[np.ndarray],
    mask_prob: float,
    mask_length: int,
    mask_type: str = "static",
    mask_other: float = 0.0,
    min_masks: int = 0,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Boolean (B, T) mask of positions chosen for masking."""
    rng = rng or np.random.RandomState()
    bsz, all_sz = shape
    mask = np.zeros((bsz, all_sz), dtype=bool)

    all_num_mask = max(
        min_masks, int(mask_prob * all_sz / float(mask_length) + rng.rand())
    )

    mask_idcs = []
    for i in range(bsz):
        if padding_mask is not None:
            sz = all_sz - int(padding_mask[i].sum())
            num_mask = max(
                min_masks, int(mask_prob * sz / float(mask_length) + rng.rand())
            )
        else:
            sz = all_sz
            num_mask = all_num_mask

        if mask_type == "static":
            lengths = np.full(num_mask, mask_length)
        elif mask_type == "uniform":
            lengths = rng.randint(int(mask_other), mask_length * 2 + 1, size=num_mask)
        else:
            raise ValueError(f"unsupported mask_type {mask_type!r}")

        if lengths.sum() == 0:
            lengths[0] = min(mask_length, sz - 1)

        min_len = int(lengths.min())
        if sz - min_len <= num_mask:
            min_len = sz - num_mask - 1
        starts = rng.choice(sz - min_len, num_mask, replace=False)
        idc = np.asarray(
            [s + off for s, ln in zip(starts, lengths) for off in range(ln)]
        )
        mask_idcs.append(np.unique(idc[idc < sz]))

    min_count = min(len(m) for m in mask_idcs)
    for i, idc in enumerate(mask_idcs):
        if len(idc) > min_count:
            idc = rng.choice(idc, min_count, replace=False)
        mask[i, idc] = True
    return mask


def apply_span_mask(
    features: np.ndarray,  # (B, T, ...) input features
    mask: np.ndarray,  # (B, T) bool
    mask_value: Optional[np.ndarray] = None,  # e.g. learned mask_emb, else 0
) -> np.ndarray:
    """Zero (or replace) masked positions (apply_input_mask, avhubert.py:299)."""
    out = features.copy()
    if mask_value is None:
        out[mask] = 0
    else:
        out[mask] = mask_value
    return out
