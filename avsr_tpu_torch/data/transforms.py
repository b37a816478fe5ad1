"""Audio/video transforms and train-time augmentations (host-side numpy).

The port's copy of ``avsr_tpu/data/transforms.py``. Mirrors the reference
collator transforms (reference src/dataset/avhubert_dataset.py:122-275) with
explicit numpy RNG instead of global random state:

  video: /255 -> crop 88x88 (random at train, center at test)
         -> [train] AdaptiveTimeMask(10, 25) -> normalize (0.421, 0.165)
  audio: [train] AdaptiveTimeMask(6400, 16000) -> interferer/noise SNR mixing
         -> logfbank + stack4 + frame layer-norm (ops/fbank)
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from avsr_tpu_torch.data.wire import VIDEO_MEAN, VIDEO_STD
from avsr_tpu_torch.ops import fbank as F

CROP = 88


def center_crop(frames: np.ndarray, size: int = CROP) -> np.ndarray:
    h, w = frames.shape[1:3]
    y = (h - size) // 2
    x = (w - size) // 2
    return frames[:, y : y + size, x : x + size]


def random_crop(frames: np.ndarray, rng: np.random.RandomState, size: int = CROP):
    h, w = frames.shape[1:3]
    y = rng.randint(0, h - size + 1)
    x = rng.randint(0, w - size + 1)
    return frames[:, y : y + size, x : x + size]


def adaptive_time_mask(
    x: np.ndarray, window: int, stride: int, rng: np.random.RandomState
) -> np.ndarray:
    """Zero out random time spans: n_mask ~ length/stride spans of len < window.

    Reference AdaptiveTimeMask (avhubert_dataset.py:131-151).
    """
    x = x.copy()
    length = x.shape[0]
    n_mask = int((length + stride - 0.1) // stride)
    ts = rng.randint(0, window, size=(n_mask, 2))
    for t, t_end in ts:
        if length - t <= 0:
            continue
        t_start = rng.randint(0, length - t)
        if t_start == t_start + t:
            continue
        x[t_start : t_start + t + t_end] = 0
    return x


def add_noise_snr(
    speech: np.ndarray, noise: np.ndarray, snr_db: float
) -> np.ndarray:
    """Mix noise into speech at the given SNR (torchaudio add_noise semantics)."""
    if len(noise) < len(speech):
        reps = int(np.ceil(len(speech) / len(noise)))
        noise = np.tile(noise, reps)
    noise = noise[: len(speech)]
    energy_s = np.sum(speech**2)
    energy_n = np.sum(noise**2)
    if energy_n == 0:
        return speech
    scale = np.sqrt(energy_s / (energy_n * 10 ** (snr_db / 10)))
    return speech + scale * noise


SNR_LEVELS = (-5, 0, 5, 10, 15, 20)
INTERFERER_COUNTS = (0, 0, 1, 2)


def mix_interferers(
    speech: np.ndarray,
    sample_interferer: Callable[[np.random.RandomState], Optional[np.ndarray]],
    rng: np.random.RandomState,
) -> np.ndarray:
    """AddMultiSpk (avhubert_dataset.py:181-222): mix 0-2 interfering
    utterances (2-10 s long) at SNR in {-5..20} dB."""
    if len(speech) / F.SAMPLE_RATE < 2:
        return speech
    n = INTERFERER_COUNTS[rng.randint(len(INTERFERER_COUNTS))]
    mix = None
    for _ in range(n):
        interferer = sample_interferer(rng)
        if interferer is None:
            continue
        dur = len(interferer) / F.SAMPLE_RATE
        if not (2 <= dur <= 10):
            continue
        interferer = F.cut_or_pad_np(interferer, len(speech))
        if mix is None:
            mix = interferer
        else:
            snr = SNR_LEVELS[:-1][rng.randint(5)]
            mix = add_noise_snr(mix, interferer, snr)
    if mix is None:
        return speech
    snr = SNR_LEVELS[rng.randint(len(SNR_LEVELS))]
    return add_noise_snr(speech, mix, snr)


class VideoTransform:
    """(T, H, W, 1) [0,255] -> cropped (T, 88, 88, 1).

    device_norm=False matches the reference exactly (host-side /255 +
    normalize). device_norm=True keeps the crops uint8 so the recognizer
    ships them to the accelerator at 1/4 the bytes and normalizes there.
    """

    def __init__(self, subset: str = "test", device_norm: bool = False):
        self.train = subset == "train"
        self.device_norm = device_norm

    def __call__(
        self, frames: np.ndarray, rng: Optional[np.random.RandomState] = None
    ) -> np.ndarray:
        if self.device_norm:
            # uint8 end-to-end: crop and time-mask commute with the /255 +
            # normalize the device applies (masked spans are 0 either way,
            # matching the reference order /255 -> crop -> mask -> normalize)
            x = np.asarray(frames)
            if x.dtype != np.uint8:
                x = x.astype(np.uint8)
            if self.train:
                rng = rng or np.random.RandomState()
                x = random_crop(x, rng)
                return adaptive_time_mask(x, 10, 25, rng)
            return center_crop(x)
        x = frames.astype(np.float32) / 255.0
        if self.train:
            rng = rng or np.random.RandomState()
            x = random_crop(x, rng)
            x = adaptive_time_mask(x, 10, 25, rng)
        else:
            x = center_crop(x)
        return (x - VIDEO_MEAN) / VIDEO_STD


class RawAudioTransform:
    """(T,) waveform -> (T, 1) layer-normalized raw waveform (av_dataset.py:193).

    Used by the conformer (auto_avsr/auto_asr) family, whose audio frontend
    consumes the waveform directly.
    """

    def __init__(self, subset: str = "test", snr_target: Optional[float] = None,
                 noise: Optional[np.ndarray] = None):
        self.train = subset == "train"
        self.noise = noise
        self.snr_target = snr_target

    def __call__(self, wave: np.ndarray,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        wave = np.asarray(wave, np.float32).reshape(-1)
        if self.train:
            rng = rng or np.random.RandomState()
            wave = adaptive_time_mask(wave, 6400, 16000, rng)
        elif self.snr_target is not None and self.noise is not None:
            start = np.random.randint(0, max(1, len(self.noise) - len(wave)))
            wave = add_noise_snr(
                wave, self.noise[start : start + len(wave)], self.snr_target
            )
        mean = wave.mean()
        var = wave.var()
        return ((wave - mean) / np.sqrt(var + 1e-8))[:, None]


class AudioTransform:
    """(T,) waveform -> (T/640, 104) stacked log-fbank features."""

    def __init__(
        self,
        subset: str = "test",
        sample_interferer: Optional[Callable] = None,
        noise: Optional[np.ndarray] = None,
        snr_target: Optional[float] = None,
    ):
        self.train = subset == "train"
        self.sample_interferer = sample_interferer
        self.noise = noise
        self.snr_target = snr_target

    def __call__(
        self, wave: np.ndarray, rng: Optional[np.random.RandomState] = None
    ) -> np.ndarray:
        wave = np.asarray(wave, np.float32).reshape(-1)
        if self.train:
            rng = rng or np.random.RandomState()
            wave = adaptive_time_mask(wave, 6400, 16000, rng)
            if self.sample_interferer is not None:
                wave = mix_interferers(wave, self.sample_interferer, rng)
            if self.noise is not None:
                snr = SNR_LEVELS[rng.randint(len(SNR_LEVELS))]
                start = rng.randint(0, max(1, len(self.noise) - len(wave)))
                wave = add_noise_snr(wave, self.noise[start : start + len(wave)], snr)
        elif self.snr_target is not None and self.noise is not None:
            start = np.random.randint(0, max(1, len(self.noise) - len(wave)))
            wave = add_noise_snr(
                wave, self.noise[start : start + len(wave)], self.snr_target
            )
        return F.fbank_stack_np(wave)
