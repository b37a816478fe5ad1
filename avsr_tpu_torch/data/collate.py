"""Batch collation: samples -> padded model-layout batches.

The port's copy of ``avsr_tpu/data/collate.py``. Equivalent of the reference
DataCollator (avhubert_dataset.py:313-352), but emitting channels-last
layouts:
  videos (B, T, 88, 88, 1), audios (B, T, 104), labels (B, L) padded -1,
  plus video/label lengths. Optional shape bucketing caps the number of
  distinct shapes. A feature with ``video_frames`` and ``audio_wave`` is
  taken pre-decoded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from avsr_tpu_torch.data import media
from avsr_tpu_torch.data.tokenizer import TextTransform
from avsr_tpu_torch.data.transforms import AudioTransform, VideoTransform
from avsr_tpu_torch.ops import fbank as F


def _bucket(n: int, buckets: Optional[Sequence[int]]) -> int:
    if not buckets:
        return n
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class DataCollator:
    text_transform: Optional[TextTransform] = None
    video_transform: VideoTransform = field(default_factory=lambda: VideoTransform("test"))
    audio_transform: AudioTransform = field(default_factory=lambda: AudioTransform("test"))
    rate_ratio: int = F.RATE_RATIO
    t_buckets: Optional[Sequence[int]] = None
    l_buckets: Optional[Sequence[int]] = None
    seed: Optional[int] = None

    def __call__(
        self, features: List[Dict], group_index: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        # Per-group seeding: a fixed seed alone would replay the identical
        # augmentation sequence (crops/time-masks/noise draws) on every
        # batch in every worker. The training loop threads a monotonically
        # increasing group index through so each batch gets a distinct,
        # still-reproducible stream; group_index=None keeps direct calls
        # (eval engine, tests) on the old fixed-seed behavior.
        seed = self.seed
        if seed is not None and group_index is not None:
            seed = (seed + group_index) % (2**31)
        rng = np.random.RandomState(seed)
        videos, audios, labels = [], [], []
        for feat in features:
            start = feat.get("start_time", 0.0)
            end = feat.get("end_time")
            if "video_frames" in feat:  # pre-decoded
                vid = feat["video_frames"]
                wave = feat["audio_wave"]
            else:
                vid = media.load_video(feat["video"], start, end)
                wave = media.load_audio(feat["video"], start, end)
            wave = F.cut_or_pad_np(wave.reshape(-1), len(vid) * self.rate_ratio)
            videos.append(self.video_transform(vid, rng))
            audios.append(self.audio_transform(wave, rng))
            if "label" in feat and self.text_transform is not None:
                labels.append(self.text_transform.tokenize(feat["label"]))

        b = len(videos)
        t_max = _bucket(max(len(v) for v in videos), self.t_buckets)
        # audio rows per video frame: 1 for fbank features (104-d), 640 for
        # raw waveform (1-d, conformer family)
        a0 = audios[0].reshape(len(audios[0]), -1)
        audio_rate = max(1, len(a0) // len(videos[0]))
        audio_dim = a0.shape[-1]
        vdtype = videos[0].dtype if videos[0].dtype == np.uint8 else np.float32
        batch = {
            "videos": np.zeros((b, t_max, 88, 88, 1), vdtype),
            "audios": np.zeros((b, t_max * audio_rate, audio_dim), np.float32),
            "video_lengths": np.asarray([len(v) for v in videos], np.int32),
        }
        for i, (v, a) in enumerate(zip(videos, audios)):
            batch["videos"][i, : len(v)] = v
            a = a.reshape(len(a), -1)
            batch["audios"][i, : len(a)] = a

        if labels:
            l_max = _bucket(max(1, max(len(l) for l in labels)), self.l_buckets)
            lab = np.full((b, l_max), -1, np.int32)
            for i, l in enumerate(labels):
                lab[i, : len(l)] = l
            batch["labels"] = lab
            batch["label_lengths"] = np.asarray([len(l) for l in labels], np.int32)
        return batch
