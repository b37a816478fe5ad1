"""Host-side media decode: video frames + 16 kHz mono audio.

The port's copy of ``avsr_tpu/data/media.py``: the loaders and the two
writers that fixtures use. Equivalent of the reference's torchcodec-based
loaders (reference src/dataset/avhubert_dataset.py:36-83). Backends are
probed in order of preference, each imported only when it is tried, so the
framework runs across environments:

  video: pyav -> cv2.VideoCapture (FFMPEG build)
  audio: pyav -> scipy (wav sidecar) -> ffmpeg CLI

Video returns grayscale (T, H, W, 1) uint8-like float32 frames (the datasets
ship pre-cropped 96x96 mouth ROIs); audio returns (T,) float32 at 16 kHz.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np

SAMPLE_RATE = 16000


# --------------------------------------------------------------------------
# video
# --------------------------------------------------------------------------


def _load_video_cv2(path: str, start_time: float, end_time: Optional[float]):
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cv2 cannot open {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    frames = []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        t = idx / fps
        idx += 1
        if t < start_time:
            continue
        if end_time is not None and t >= end_time:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path} [{start_time}, {end_time})")
    return np.stack(frames).astype(np.float32)[..., None]


def _load_video_pyav(path: str, start_time: float, end_time: Optional[float]):
    import av  # type: ignore
    import cv2

    frames = []
    with av.open(path) as container:
        stream = container.streams.video[0]
        for frame in container.decode(stream):
            t = float(frame.pts * stream.time_base)
            if t < start_time:
                continue
            if end_time is not None and t >= end_time:
                break
            rgb = frame.to_ndarray(format="rgb24")
            frames.append(cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames).astype(np.float32)[..., None]


# bounded retry on decode failure: transient I/O errors on network-mounted
# or streaming-downloaded media are common at dataset scale (the reference
# retries a corrupt video 3x — src/avhubert_muavic/utils.py:14-30)
DECODE_RETRIES = 3


def load_video(
    path: str, start_time: float = 0.0, end_time: Optional[float] = None
) -> np.ndarray:
    """Grayscale frames (T, H, W, 1) float32 in [0, 255]."""
    errors = []
    for attempt in range(DECODE_RETRIES):
        for fn in (_load_video_pyav, _load_video_cv2):
            try:
                return fn(path, start_time, end_time)
            except ImportError as e:
                errors.append(str(e))
            except Exception as e:  # backend-specific decode failure
                errors.append(f"{fn.__name__}: {e}")
        if attempt < DECODE_RETRIES - 1:
            print(f"failed loading {path} ({attempt + 1} / {DECODE_RETRIES})")
    raise IOError(f"all video backends failed for {path}: {errors}")


# --------------------------------------------------------------------------
# audio
# --------------------------------------------------------------------------


def _slice_audio(wave: np.ndarray, sr: int, start_time: float, end_time):
    if sr != SAMPLE_RATE:
        raise IOError(f"expected {SAMPLE_RATE} Hz, got {sr}")
    lo = int(start_time * sr)
    hi = len(wave) if end_time is None else int(end_time * sr)
    return wave[lo:hi]


def _load_audio_wav(path: str, start_time: float, end_time):
    from scipy.io import wavfile

    wav_path = path if path.endswith(".wav") else os.path.splitext(path)[0] + ".wav"
    if not os.path.exists(wav_path):
        raise IOError(f"no wav sidecar for {path}")
    sr, wave = wavfile.read(wav_path)
    if wave.dtype == np.int16:
        wave = wave.astype(np.float32) / 32768.0
    elif wave.dtype == np.int32:
        wave = wave.astype(np.float32) / 2147483648.0
    else:
        wave = wave.astype(np.float32)
    if wave.ndim > 1:
        wave = wave.mean(axis=1)
    return _slice_audio(wave, sr, start_time, end_time)


def _load_audio_pyav(path: str, start_time: float, end_time):
    import av  # type: ignore

    chunks = []
    with av.open(path) as container:
        stream = container.streams.audio[0]
        resampler = av.AudioResampler(format="flt", layout="mono", rate=SAMPLE_RATE)
        for frame in container.decode(stream):
            for rf in resampler.resample(frame):
                chunks.append(rf.to_ndarray().reshape(-1))
    wave = np.concatenate(chunks)
    return _slice_audio(wave, SAMPLE_RATE, start_time, end_time)


def _load_audio_ffmpeg(path: str, start_time: float, end_time):
    if shutil.which("ffmpeg") is None:
        raise IOError("no ffmpeg binary")
    cmd = ["ffmpeg", "-v", "quiet", "-i", path, "-f", "f32le", "-ac", "1",
           "-ar", str(SAMPLE_RATE), "-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    wave = np.frombuffer(raw, np.float32)
    return _slice_audio(wave, SAMPLE_RATE, start_time, end_time)


def load_audio(
    path: str, start_time: float = 0.0, end_time: Optional[float] = None
) -> np.ndarray:
    """Mono float32 waveform (T,) at 16 kHz."""
    errors = []
    for attempt in range(DECODE_RETRIES):
        for fn in (_load_audio_pyav, _load_audio_wav, _load_audio_ffmpeg):
            try:
                return fn(path, start_time, end_time)
            except ImportError as e:
                errors.append(str(e))
            except Exception as e:
                errors.append(f"{fn.__name__}: {e}")
        if attempt < DECODE_RETRIES - 1:
            print(f"failed loading {path} ({attempt + 1} / {DECODE_RETRIES})")
    raise IOError(f"all audio backends failed for {path}: {errors}")


# --------------------------------------------------------------------------
# writers (preprocessing outputs: trimmed crops + audio + transcripts,
# reference retinaface/utils.py:50-103)
# --------------------------------------------------------------------------


def save_video(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
    """Write (T, H, W[, C]) frames as mp4 (grayscale is replicated to BGR)."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[..., None]
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h), isColor=True
    )
    if not writer.isOpened():
        raise IOError(f"cannot open video writer for {path}")
    for frame in frames.astype(np.uint8):
        if frame.shape[-1] == 1:
            frame = np.repeat(frame, 3, axis=-1)
        writer.write(frame)
    writer.release()


def save_audio(path: str, wave: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """Write a float32 (T,) waveform as 16-bit PCM wav."""
    from scipy.io import wavfile

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pcm = np.clip(np.asarray(wave, np.float32).reshape(-1), -1.0, 1.0)
    wavfile.write(path, sample_rate, (pcm * 32767).astype(np.int16))
