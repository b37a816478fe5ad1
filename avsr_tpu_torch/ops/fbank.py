"""Log mel-filterbank features with python_speech_features-compatible semantics.

The port's copy of the numpy part of ``avsr_tpu/ops/fbank.py``. The
reference pipeline (reference ``src/dataset/avhubert_dataset.py:86-116``,
``FBanksAndStack``) computes ``python_speech_features.logfbank(wave,
samplerate=16000)`` with library defaults — 25 ms rectangular window, 10 ms
hop, 26 mel filters, NFFT 512, pre-emphasis 0.97 — then stacks 4
consecutive frames into a 104-dim vector at 25 Hz and applies a per-frame
LayerNorm (no learned affine).

:func:`fbank_stack_np` dispatches as the JAX package's does: to the C++
featurizer (``avsr_tpu_torch/native/fbank.cpp``) when it is built, to numpy
otherwise. The library is built at first use, with one ``g++`` call, into
``build/avsr_tpu_torch/``; :func:`fbank_route` says which route runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import subprocess
from pathlib import Path

import numpy as np

from avsr_tpu_torch.ops.kernels._build import BUILD_DIR

SAMPLE_RATE = 16000
WIN_LEN = 400  # 25 ms at 16 kHz
WIN_STEP = 160  # 10 ms
NFILT = 26
NFFT = 512
PREEMPH = 0.97
STACK_ORDER = 4
RATE_RATIO = 640  # audio samples per video frame (16000 / 25)

NATIVE_SRC = Path(__file__).resolve().parents[1] / "native" / "fbank.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def _hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def mel_filterbank(
    nfilt: int = NFILT,
    nfft: int = NFFT,
    samplerate: int = SAMPLE_RATE,
    lowfreq: float = 0.0,
    highfreq: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank matrix (nfilt, nfft//2 + 1), float64.

    Matches python_speech_features.get_filterbanks: integer FFT-bin breakpoints
    via floor((nfft+1) * hz / samplerate).
    """
    highfreq = highfreq or samplerate / 2
    lowmel = _hz2mel(lowfreq)
    highmel = _hz2mel(highfreq)
    melpoints = np.linspace(lowmel, highmel, nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz(melpoints) / samplerate).astype(np.int64)

    fbank = np.zeros((nfilt, nfft // 2 + 1), dtype=np.float64)
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank


def num_frames(slen: int) -> int:
    """Number of analysis frames python_speech_features produces for slen samples."""
    if slen <= WIN_LEN:
        return 1
    return 1 + int(math.ceil((slen - WIN_LEN) / WIN_STEP))


def logfbank_np(signal: np.ndarray) -> np.ndarray:
    """Log mel-filterbank energies, (T, 26) float32. Numpy golden path."""
    sig = np.asarray(signal, dtype=np.float64).reshape(-1)
    # Pre-emphasis, keeping the first sample as-is.
    sig = np.concatenate([sig[:1], sig[1:] - PREEMPH * sig[:-1]])
    T = num_frames(len(sig))
    padlen = (T - 1) * WIN_STEP + WIN_LEN
    sig = np.concatenate([sig, np.zeros(max(0, padlen - len(sig)))])
    idx = np.arange(WIN_LEN)[None, :] + WIN_STEP * np.arange(T)[:, None]
    frames = sig[idx]
    # Rectangular window (python_speech_features default winfunc is ones).
    pspec = (1.0 / NFFT) * np.abs(np.fft.rfft(frames, NFFT)) ** 2
    feat = pspec @ mel_filterbank().T
    feat = np.where(feat == 0.0, np.finfo(np.float64).eps, feat)
    return np.log(feat).astype(np.float32)


def stack_frames_np(feats: np.ndarray, stack_order: int = STACK_ORDER) -> np.ndarray:
    """Concatenate stack_order consecutive frames: (T, F) -> (ceil(T/s), F*s)."""
    t, f = feats.shape
    if t % stack_order:
        pad = stack_order - t % stack_order
        feats = np.concatenate([feats, np.zeros((pad, f), dtype=feats.dtype)])
    return feats.reshape(-1, stack_order * f)


def native_library_path() -> Path:
    """The featurizer's library, named by a hash of its source and flags,
    so an edited source rebuilds."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"libavsr_native_{h.hexdigest()[:16]}.so"


@functools.cache
def _load_native():
    """ctypes handle to the C++ featurizer, or None where it cannot be
    built or loaded (numpy serves then, as in the JAX package).

    Built at first use when missing (one g++ call, ~2 s), into a
    process-private name first and then renamed, so concurrent processes
    load all or nothing."""
    so = native_library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.fbank_stack.restype = ctypes.c_int
    lib.fbank_stack.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.fbank_stack_rows.restype = ctypes.c_int
    lib.fbank_stack_rows.argtypes = [ctypes.c_int]
    return lib


# runtime switch (benchmarks/tests flip this to compare the numpy path
# against the C++ featurizer without rebuilding)
USE_NATIVE = True


def fbank_route() -> str:
    """"native" or "numpy": the route :func:`fbank_stack_np` takes now
    (building the native library first if it is missing)."""
    return "native" if USE_NATIVE and _load_native() is not None else "numpy"


def fbank_stack_native(signal: np.ndarray) -> np.ndarray:
    """C++ featurizer path (identical math, ~an order of magnitude faster
    than numpy per call on the host data plane)."""
    lib = _load_native()
    wave = np.ascontiguousarray(signal, dtype=np.float32).reshape(-1)
    rows = lib.fbank_stack_rows(len(wave))
    out = np.empty((rows, 104), np.float32)
    written = lib.fbank_stack(
        wave.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(wave),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out[:written]


def fbank_stack_np(signal: np.ndarray) -> np.ndarray:
    """Full reference audio featurizer: logfbank -> stack4 -> per-frame LayerNorm.

    Returns (ceil(T/4), 104) float32, matching FBanksAndStack.forward.
    Dispatches to the native C++ implementation when built.
    """
    if fbank_route() == "native":
        return fbank_stack_native(signal)
    feats = stack_frames_np(logfbank_np(signal))
    mean = feats.mean(axis=-1, keepdims=True)
    var = feats.var(axis=-1, keepdims=True)
    return ((feats - mean) / np.sqrt(var + 1e-5)).astype(np.float32)


def cut_or_pad_np(audio: np.ndarray, size: int) -> np.ndarray:
    """Trim/zero-pad a (T,) or (T, C) waveform to exactly ``size`` samples.

    Mirrors avhubert_dataset.cut_or_pad (reference :22-33): audio is forced to
    ``len(video) * 640`` samples so fbank+stack yields one row per video frame.
    """
    if audio.shape[0] < size:
        pad = [(0, size - audio.shape[0])] + [(0, 0)] * (audio.ndim - 1)
        audio = np.pad(audio, pad)
    elif audio.shape[0] > size:
        audio = audio[:size]
    return audio
