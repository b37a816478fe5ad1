"""Synthetic serving inputs: fbank-shaped audio and smooth uint8 lip crops.

The crops follow ``bench.py:60-78``: a smooth low-resolution motion field
interpolated between keyframes plus a static texture, so frame-to-frame
deltas are a few gray levels, as in real mouth-region video.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def smooth_crops(rng: np.random.RandomState, t: int) -> np.ndarray:
    """uint8 crops (t, 88, 88, 1)."""
    key_every = 6
    n_keys = t // key_every + 2
    keys = np.kron(rng.randn(n_keys, 12, 12), np.ones((1, 8, 8)))[:, :88, :88]
    idx = np.arange(t) / key_every
    i0 = idx.astype(np.int64)
    w = (idx - i0)[:, None, None]
    frames = keys[i0] * (1 - w) + keys[i0 + 1] * w
    texture = rng.randn(1, 88, 88) * 10.0
    vid = (128 + 16 * frames + texture).clip(0, 255).astype(np.uint8)
    return vid[..., None]


def synthetic_batch(rng: np.random.RandomState, lengths
                    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(audio (t, 104) fp32, video (t, 88, 88, 1) uint8) lists, one pair
    per length, in the shapes ``Recognizer.transcribe_batch`` takes."""
    audio = [rng.randn(t, 104).astype(np.float32) for t in lengths]
    video = [smooth_crops(rng, t) for t in lengths]
    return audio, video
