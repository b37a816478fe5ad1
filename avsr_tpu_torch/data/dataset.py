"""Training datasets: the streamed HF mixture (online) and synthetic samples
(offline).

The port's copy of ``avsr_tpu/data/dataset.py``: the reference mixture
recipe (LRS2 train+pretrain 0.30, VoxCeleb2 dev 0.20, AVYT talking+silent
0.25, AVYT-mix 0.25, or with MCoRec .25/.10/.20/.25/.20, interleaved with
seed 11 and 'all_exhausted'; LRS2 train tars double as the interferer pool
for SNR augmentation; downloads retried 5x with a 10 s backoff), the
rotating ``InterfererPool``, per-rank sharding over ``torch.distributed``
and deterministic synthetic samples, the JAX package's from the same seed.
``datasets`` is imported only inside ``load_avsr_mixture``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np

MIXTURE_PROBS = {"lrs2": 0.3, "vox2": 0.2, "avyt": 0.25, "avyt-mix": 0.25}
MIXTURE_PROBS_MCOREC = {
    "lrs2": 0.25,
    "vox2": 0.10,
    "avyt": 0.20,
    "avyt-mix": 0.25,
    "mcorec": 0.2,
}
INTERLEAVE_SEED = 11


def _retry(fn, tries: int = 5, sleep_s: float = 10.0):
    for attempt in range(tries):
        try:
            return fn()
        except Exception:
            if attempt == tries - 1:
                raise
            time.sleep(sleep_s)


def load_avsr_mixture(
    cache_dir: str = "data-bin/cache",
    include_mcorec: bool = False,
    streaming: bool = True,
):
    """Build (train, valid, interferer) HF datasets (requires network)."""
    import datasets

    def load(config):
        return _retry(
            lambda: datasets.load_dataset(
                "nguyenvulebinh/AVYT", config, streaming=streaming,
                cache_dir=cache_dir,
            ).remove_columns(["__key__", "__url__"])
        )

    lrs2, vox2, avyt, avyt_mix = (load("lrs2"), load("vox2"), load("avyt"),
                                  load("avyt-mix"))
    mcorec = None
    if include_mcorec:
        mcorec = _retry(
            lambda: datasets.load_dataset(
                "MCoRecChallenge/MCoRec", streaming=streaming,
                cache_dir=cache_dir,
            ).remove_columns(["__key__", "__url__"])
        )

    if not streaming:
        for ds in filter(None, [lrs2, vox2, avyt, avyt_mix, mcorec]):
            for split in ds:
                n = len(ds[split])
                shards = max(20, n // 10000) if n > 10000 else 1
                ds[split] = ds[split].to_iterable_dataset(num_shards=shards)

    probs = MIXTURE_PROBS_MCOREC if include_mcorec else MIXTURE_PROBS
    trains = {
        "lrs2": datasets.concatenate_datasets([lrs2["train"],
                                               lrs2["pretrain"]]),
        "vox2": vox2["dev"],
        "avyt": datasets.concatenate_datasets([avyt["talking"],
                                               avyt["silent"]]),
        "avyt-mix": avyt_mix["train"],
    }
    valids = [lrs2["valid"], lrs2["test_snr_0_interferer_2"], avyt_mix["test"]]
    if include_mcorec:
        trains["mcorec"] = mcorec["train"]
        valids = [mcorec["valid"]]

    train = datasets.interleave_datasets(
        [trains[k] for k in probs],
        probabilities=[probs[k] for k in probs],
        seed=INTERLEAVE_SEED,
        stopping_strategy="all_exhausted",
    )
    valid = datasets.interleave_datasets(valids,
                                         stopping_strategy="first_exhausted")

    def fmt(sample):
        if isinstance(sample.get("label"), bytes):
            sample["label"] = sample["label"].decode("utf-8")
        return sample

    interferer = _retry(
        lambda: datasets.load_dataset(
            "nguyenvulebinh/AVYT", "lrs2", cache_dir=cache_dir,
            data_files="lrs2/lrs2-train-*.tar",
        ).remove_columns(["__key__", "__url__"])["train"]
    )
    return train.map(fmt), valid.map(fmt), interferer


def _decode_interferer_audio(sample: Dict) -> np.ndarray:
    """Decode one interferer utterance's audio track (mp4 bytes)."""
    import tempfile

    from avsr_tpu_torch.data import media

    with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
        f.write(sample["video"])
        f.flush()
        return media.load_audio(f.name)


class InterfererPool:
    """Rotating pool of decoded interferer waveforms for SNR mixing.

    Draws sample uniformly from a pool of ``size`` pre-decoded waveforms,
    and one background thread keeps rotating entries (decode a fresh random
    utterance, replace a random slot), so coverage of the source grows
    while the collator never decodes. Refresh work is rate-limited per draw
    and dropped, not queued, when the refresher is busy, so it never
    back-pressures collation. Usable directly as
    ``AudioTransform.sample_interferer``: ``pool(rng)``.
    """

    def __init__(
        self,
        dataset,
        size: int = 256,
        decode_fn: Optional[Callable[[Dict], np.ndarray]] = None,
        warm_start: int = 8,
        refresh_per_draw: float = 0.25,
        seed: int = 0,
    ):
        self._ds = dataset
        self._decode = decode_fn or _decode_interferer_audio
        self._size = size
        self._entries: list = []
        self._rng = np.random.RandomState(seed)
        self._pending = 0.0
        self.refresh_per_draw = refresh_per_draw
        self.refreshes = 0  # completed background rotations
        self._work: "queue.Queue" = queue.Queue(maxsize=2)
        for _ in range(max(1, min(warm_start, size))):
            self._fill_one()
        self._thread = threading.Thread(target=self._refresher, daemon=True)
        self._thread.start()

    def _fill_one(self) -> None:
        wave = self._decode(self._ds[int(self._rng.randint(len(self._ds)))])
        if len(self._entries) < self._size:
            self._entries.append(wave)  # grow phase
        else:
            self._entries[int(self._rng.randint(self._size))] = wave  # rotate
        self.refreshes += 1

    def _refresher(self) -> None:
        while True:
            self._work.get()
            try:
                self._fill_one()
            except Exception:
                # one corrupt interferer must not stop training: the slot
                # keeps its waveform and the next rotation retries
                pass

    def __call__(self, rng: np.random.RandomState) -> np.ndarray:
        self._pending += self.refresh_per_draw
        if self._pending >= 1.0:
            self._pending -= 1.0
            try:
                self._work.put_nowait(None)
            except queue.Full:
                pass  # refresher busy: drop, never block the collator
        entries = self._entries  # grows append-only; a slot swap is atomic
        return entries[int(rng.randint(len(entries)))]


def shard_for_host(dataset, process_index: Optional[int] = None,
                   process_count: Optional[int] = None):
    """Give each data rank a distinct set of shards (per-rank tar sharding,
    reference train.py:82-85 with dispatch_batches=False). Index and count
    default to ``core/dist``'s data rank and size (0 and 1 without a
    process group): the ranks of one model group read the same shard."""
    from avsr_tpu_torch.core import dist

    if process_index is None:
        process_index = dist.data_rank()
    if process_count is None:
        process_count = dist.data_size()
    if process_count == 1:
        return dataset
    if hasattr(dataset, "shard"):
        return dataset.shard(num_shards=process_count, index=process_index)
    # a plain iterable: every process_count-th sample from process_index
    import itertools

    return itertools.islice(dataset, process_index, None, process_count)


# ---------------------------------------------------------------------------
# synthetic offline dataset
# ---------------------------------------------------------------------------

_WORDS = (
    "THE QUICK BROWN FOX JUMPS OVER LAZY DOG WE ARE BUILDING SPEECH MODELS "
    "ON TENSOR PROCESSING UNITS WITH GOOD RESULTS EVERY DAY"
).split()


def synthetic_samples(
    n: int, seed: int = 0, min_frames: int = 16, max_frames: int = 80
) -> Iterator[Dict]:
    """Deterministic pre-decoded AV samples for offline pipelines/tests."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        t = int(rng.randint(min_frames, max_frames + 1))
        n_words = int(rng.randint(2, 8))
        words = [str(_WORDS[rng.randint(len(_WORDS))]) for _ in range(n_words)]
        yield {
            "sample_id": f"synthetic_{i}",
            "video_frames": rng.randint(0, 256, size=(t, 96, 96, 1)).astype(
                np.float32
            ),
            "audio_wave": (rng.randn(t * 640) * 0.1).astype(np.float32),
            "label": " ".join(words),
            "length": t,
        }
