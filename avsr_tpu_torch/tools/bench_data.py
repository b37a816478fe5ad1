"""Data-plane soak: can the host feed the port's train step on the card?

    python -m avsr_tpu_torch.tools.bench_data [--steps 300] [--batch 6]
        [--grad_accum 2] [--clips 48] [--workers 10] [--host_batches 30]

Counterpart of the root ``bench_data.py``: synthesizes a pool of real mp4
(25 fps, 96x96 gray) + 16 kHz wav clips of 3-10 s, streams them through
the full train collator (cv2 decode, SNR mixing with the rotating
``InterfererPool`` + time-mask augmentation, log-fbank featurizer, uint8
crops) and runs the port's train step (``train/trainer.py``: the flagship
with seed-0 weights, bf16 compute over fp32 masters, ``--grad_accum``
micro-batches of ``--batch``) against the stream. Three phases:

  A. device demand: one pre-collated batch fed repeatedly, samples/s the
     step consumes with no host cost (20 steps, or ``--steps`` if fewer);
  B. host supply: collation-only samples/s of ``train/loop.py``
     ``batches_from_samples`` at 0, 4 and ``--workers`` threads with the
     native featurizer on and off (``ops/fbank.USE_NATIVE``), and at 4
     and ``--workers`` ``spawn`` processes with it on, ``--host_batches``
     batches each after 2 x workers warm batches (the batches a pool keeps
     in flight; one without workers);
  C. end-to-end soak: after one step at each (frames, labels) bucket the
     pool can give, ``--steps`` steps of the real loop (streaming
     collator at ``--workers`` threads -> ``device_prefetch`` -> train
     step), a loss fetched every 25 steps (every ``--steps`` / 4 when
     that is fewer); the steady rate is the last half of those intervals.

Every point draws its interferers from an ``InterfererPool`` over the
fixture pool (``Interferers``): thread workers share the parent's pool and
its refresher thread; a thread cannot cross into a ``spawn`` process, so
each process worker builds its own at its first draw. The refresh work a
draw is the same either way. The tokenizer is the SentencePiece assets'
(``AVSR_SPM_DIR``) or, without them, a unigram model trained on the
pool's words; which one is printed. The pool lives in a temporary
directory (under ``root`` if given) that is removed at the end. Prints
one line a measurement, the card's nvidia-smi name and power limit, and
one JSON object as the last line with the root script's keys.
``main(argv, model_cfg, device, root)`` runs another config or device
(the tests: a tiny config on the CPU); the command runs the flagship on
``cuda`` and exits without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional
import time

import numpy as np
import torch

WORDS = (
    "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG WHILE WE BENCHMARK "
    "SUSTAINED AUDIO VISUAL STREAMING ON TENSOR PROCESSING UNITS"
).split()
DEVICE_STEPS = 20  # phase A's timed steps
SYNC_EVERY = 25  # phase C's loss fetches


def build_fixture_pool(root: str, n_clips: int, seed: int = 0):
    """Synthesize mp4 (25 fps, 96x96 gray) + 16 kHz wav sidecars, 3-10 s."""
    from avsr_tpu_torch.data import media

    rng = np.random.RandomState(seed)
    samples = []
    for i in range(n_clips):
        frames = int(rng.randint(75, 250))  # 3-10 s at 25 fps
        vid = rng.randint(0, 256, size=(frames, 96, 96)).astype(np.uint8)
        wave = (rng.randn(frames * 640) * 0.1).astype(np.float32)
        path = os.path.join(root, f"clip_{i:03d}.mp4")
        media.save_video(path, vid, fps=25.0)
        media.save_audio(os.path.splitext(path)[0] + ".wav", wave)
        n_words = int(rng.randint(4, 14))
        label = " ".join(WORDS[rng.randint(len(WORDS))] for _ in range(n_words))
        samples.append({"video": path, "label": label})
    return samples


def sample_stream(samples, seed: int = 1):
    rng = np.random.RandomState(seed)
    while True:
        for idx in rng.permutation(len(samples)):
            yield dict(samples[int(idx)])


def _clip_audio(sample) -> np.ndarray:
    from avsr_tpu_torch.data import media

    return media.load_audio(sample["video"])


class Interferers:
    """The training CLI's interferer source (``InterfererPool`` of up to
    256 decoded waveforms, rotated by a background thread) over the
    fixture pool, as ``AudioTransform.sample_interferer``. The pool is
    built where the object is made and is not pickled: a ``spawn`` worker
    gets a copy without it and builds its own at its first draw."""

    def __init__(self, samples):
        self.samples = samples
        self._pool = self._build()

    def _build(self):
        from avsr_tpu_torch.data.dataset import InterfererPool

        return InterfererPool(self.samples, size=min(256, len(self.samples)),
                              decode_fn=_clip_audio)

    def __getstate__(self):
        return {"samples": self.samples, "_pool": None}

    def __call__(self, rng: np.random.RandomState) -> np.ndarray:
        if self._pool is None:  # a process worker's first draw
            self._pool = self._build()
        return self._pool(rng)


def text_transform(root: str):
    """(TextTransform, where its model came from): the SentencePiece
    assets, or a unigram model trained on WORDS under ``root``."""
    from avsr_tpu_torch.data import spm_train
    from avsr_tpu_torch.data.tokenizer import TextTransform

    try:
        return TextTransform(), "assets"
    except FileNotFoundError:
        corpus = os.path.join(root, "words.txt")
        with open(corpus, "w", encoding="utf-8") as f:
            f.write("\n".join(WORDS) + "\n")
        prefix = os.path.join(root, "unigram")
        spm_train.train_and_save(corpus, prefix, vocab_size=48)
        return (TextTransform(prefix + ".model", prefix + "_units.txt"),
                "trained on the pool's words")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--grad_accum", type=int, default=2)
    ap.add_argument("--clips", type=int, default=48)
    ap.add_argument("--workers", type=int, default=10)
    ap.add_argument("--host_batches", type=int, default=30,
                    help="batches per host-supply measurement point")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be at least 2: the steady rate needs two "
                 "loss fetches")
    return args


def main(argv=None, model_cfg=None, device="cuda",
         root: Optional[str] = None) -> dict:
    """Runs the three phases over a fixture pool in a temporary directory
    under ``root`` (the system's default when None), which it removes;
    returns the JSON record it prints last."""
    args = parse_args(argv)
    device = torch.device(device)
    smi = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_data: torch sees no CUDA device")
        from avsr_tpu_torch.tools import trace

        smi = trace.card()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="avsr_soak_", dir=root) as tmp:
        return _soak(args, tmp, model_cfg, device, smi)


def _soak(args, tmp: str, model_cfg, device: torch.device,
          smi: Optional[str]) -> dict:
    from avsr_tpu_torch.core.config import AVHubertAVSRConfig
    from avsr_tpu_torch.data.collate import DataCollator
    from avsr_tpu_torch.data.transforms import AudioTransform, VideoTransform
    from avsr_tpu_torch.ops import fbank as F
    from avsr_tpu_torch.train import trainer as T
    from avsr_tpu_torch.train.loop import (L_BUCKETS, T_BUCKETS,
                                           batches_from_samples,
                                           device_prefetch)

    print(f"fixture pool: {args.clips} clips under {tmp}", flush=True)
    samples = build_fixture_pool(tmp, args.clips)
    tt, tt_source = text_transform(tmp)
    print(f"tokenizer: {tt_source}, vocabulary {tt.vocab_size}", flush=True)
    # the training CLI's interferer path (cli/train.py): SNR mixing draws
    # 0-2 interferers a sample from a rotating pool of decoded waveforms
    # refreshed by a background thread, whose decodes compete for the host
    interferer = Interferers(samples)

    def make_collator():
        return DataCollator(
            text_transform=tt,
            video_transform=VideoTransform("train", device_norm=True),
            audio_transform=AudioTransform("train",
                                           sample_interferer=interferer),
        )

    micro, accum = args.batch, args.grad_accum
    per_step = micro * accum

    # ---- phase B: host supply (no device) --------------------------------
    host_rows = []
    native_states = [True, False] if F.fbank_route() == "native" else [False]
    counts = sorted({0, min(4, args.workers), args.workers})
    points = [(n, w, False) for n in native_states for w in counts]
    points += [(native_states[0], w, True) for w in counts if w]
    try:
        for native, workers, procs in points:
            F.USE_NATIVE = native
            batches = batches_from_samples(
                sample_stream(samples), make_collator(), micro, accum,
                num_workers=workers, use_processes=procs,
            )
            # warm caches and the pool, and let the pool reach its steady
            # state: after one batch alone, the 2 x workers in flight would
            # have been collated in parallel before the window opened
            for _ in range(max(1, 2 * workers)):
                next(batches)
            t0 = time.perf_counter()
            for _ in range(args.host_batches):
                next(batches)
            dt = time.perf_counter() - t0
            batches.close()
            rate = args.host_batches * per_step / dt
            host_rows.append({"native_fbank": native, "workers": workers,
                              "processes": procs, "samples_per_s": rate})
            print(f"host supply: native_fbank={native} workers={workers} "
                  f"processes={procs}: {rate:.3f} samples/s", flush=True)
    finally:
        F.USE_NATIVE = True

    # ---- phase A: device demand ------------------------------------------
    cfg = model_cfg or AVHubertAVSRConfig()
    cfg.encoder.use_flash_attention = True
    if tt.vocab_size > cfg.odim:
        raise ValueError(f"tokenizer vocabulary {tt.vocab_size} exceeds the "
                         f"model's odim {cfg.odim}")
    state = T.init_state(cfg, T.TrainConfig(compute_dtype="bfloat16"),
                         seed=0, device=device)
    batches = batches_from_samples(
        sample_stream(samples), make_collator(), micro, accum,
        num_workers=args.workers,
    )
    first = next(batches)
    dev_batch = T.to_device(first, device)
    T.train_step(state, dev_batch)["loss"].item()
    n_dev = min(DEVICE_STEPS, args.steps)
    t0 = time.perf_counter()
    for _ in range(n_dev):
        metrics = T.train_step(state, dev_batch)
    metrics["loss"].item()
    dev_dt = (time.perf_counter() - t0) / n_dev
    dev_rate = per_step / dev_dt
    print(f"device demand: {dev_dt:.4f} s/step = {dev_rate:.3f} samples/s "
          f"(batch {micro} x accum {accum}, frames {first['videos'].shape[2]})",
          flush=True)

    # ---- phase C: end-to-end soak ----------------------------------------
    # one step at every (frames, labels) bucket the pool can give, so the
    # soak measures throughput, not cuDNN's first choice of algorithm for
    # a shape or the allocator's growth
    t_lo = min(b for b in T_BUCKETS if b >= 75)
    t_buckets = [b for b in T_BUCKETS if t_lo <= b <= 256]
    l_buckets = [b for b in L_BUCKETS if b <= 32]
    t0 = time.perf_counter()
    for tb in t_buckets:
        for lb in l_buckets:
            dummy = {
                "videos": np.zeros((accum, micro, tb, 88, 88, 1), np.uint8),
                "audios": np.zeros((accum, micro, tb, 104), np.float32),
                "video_lengths": np.full((accum, micro), tb, np.int32),
                "labels": np.full((accum, micro, lb), 3, np.int32),
                "label_lengths": np.full((accum, micro), min(4, lb),
                                         np.int32),
            }
            metrics = T.train_step(state, T.to_device(dummy, device))
    metrics["loss"].item()
    print(f"prewarmed {len(t_buckets) * len(l_buckets)} bucket shapes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    every = min(SYNC_EVERY, max(1, args.steps // 4))
    stream = device_prefetch(batches, device)
    t0 = time.perf_counter()
    times = []
    for i in range(args.steps):
        metrics = T.train_step(state, next(stream))
        if (i + 1) % every == 0:
            metrics["loss"].item()
            times.append(time.perf_counter())
            print(f"  soak step {i + 1}/{args.steps} "
                  f"({times[-1] - t0:.1f}s elapsed)", flush=True)
    metrics["loss"].item()
    batches.close()
    half = len(times) // 2
    steady_dt = (times[-1] - times[half - 1]) / ((len(times) - half) * every)
    steady_rate = per_step / steady_dt
    print(f"end-to-end soak: {steady_rate:.3f} samples/s steady "
          f"({steady_dt:.4f} s/step, {args.steps} steps total)")
    record = {
        "metric": "data_plane_soak",
        "device_demand_samples_per_s": dev_rate,
        "end_to_end_samples_per_s": steady_rate,
        "feed_efficiency": steady_rate / dev_rate,
        "host_supply": host_rows,
        "steps": args.steps,
        "workers": args.workers,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "card": smi,
    }
    if smi:
        print(smi)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
