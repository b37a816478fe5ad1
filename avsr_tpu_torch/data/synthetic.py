"""Synthetic inputs: serving batches (fbank-shaped audio and smooth uint8 lip
crops) and training batches.

The crops follow ``bench.py:60-78``: a smooth low-resolution motion field
interpolated between keyframes plus a static texture, so frame-to-frame
deltas are a few gray levels, as in real mouth-region video. The training
batch is ``bench_train.py:85-91``'s.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def smooth_crops(rng: np.random.RandomState, t: int, size: int = 88
                 ) -> np.ndarray:
    """uint8 crops (t, size, size, 1), size <= 96: 88 as the model takes
    them, 96 as the datasets ship them (the collator crops the centre)."""
    key_every = 6
    n_keys = t // key_every + 2
    keys = np.kron(rng.randn(n_keys, 12, 12),
                   np.ones((1, 8, 8)))[:, :size, :size]
    idx = np.arange(t) / key_every
    i0 = idx.astype(np.int64)
    w = (idx - i0)[:, None, None]
    frames = keys[i0] * (1 - w) + keys[i0 + 1] * w
    texture = rng.randn(1, size, size) * 10.0
    vid = (128 + 16 * frames + texture).clip(0, 255).astype(np.uint8)
    return vid[..., None]


def synthetic_batch(rng: np.random.RandomState, lengths
                    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(audio (t, 104) fp32, video (t, 88, 88, 1) uint8) lists, one pair
    per length, in the shapes ``Recognizer.transcribe_batch`` takes."""
    audio = [rng.randn(t, 104).astype(np.float32) for t in lengths]
    video = [smooth_crops(rng, t) for t in lengths]
    return audio, video


def synthetic_train_batch(rng: np.random.RandomState, b: int, t: int, l: int,
                          video_lengths: Optional[Sequence[int]] = None,
                          label_lengths: Optional[Sequence[int]] = None,
                          vocab: int = 5000) -> Dict[str, np.ndarray]:
    """``bench_train.py``'s training batch as numpy: videos (b, t, 88, 88, 1)
    and audios (b, t, 104) fp32 N(0, 1), labels (b, l) int32, one row of
    ids in [1, vocab) tiled over the batch, padded with -1 past
    ``label_lengths``; video_lengths and label_lengths (b,) int32, full
    by default."""
    videos = rng.randn(b, t, 88, 88, 1).astype(np.float32)
    audios = rng.randn(b, t, 104).astype(np.float32)
    labels = np.tile(rng.randint(1, vocab, (1, l)), (b, 1)).astype(np.int32)
    vl = np.full((b,), t, np.int32) if video_lengths is None else (
        np.asarray(video_lengths, np.int32))
    ll = np.full((b,), l, np.int32) if label_lengths is None else (
        np.asarray(label_lengths, np.int32))
    labels[np.arange(l)[None, :] >= ll[:, None]] = -1
    return {"videos": videos, "audios": audios, "labels": labels,
            "video_lengths": vl, "label_lengths": ll}
