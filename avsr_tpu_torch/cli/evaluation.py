"""Evaluation CLI: WER on LRS2 / AVCocktail, MCoRec session inference.

The port's counterpart of ``avsr_tpu/cli/evaluation.py``, with the same
flag surface and print format (the reference's script/evaluation.py:
--model_type, --dataset_name, --set_id, --checkpoint_path, --cache_dir,
--max_length, --beam_size, --output_dir_name). Segments are collated on
the host (media decode, fbank, crops) and decoded in batches by the port's
``Recognizer`` on ``device`` (the card unless the caller asks for the CPU).

    python -m avsr_tpu_torch.cli.evaluation --help

All three model types load: avsr_cocktail (AV-HuBERT with the joint
CTC/attention beam), auto_avsr (the conformer family) and muavic_en (the
MuAViC AV2Text model, attention-only beam through ``S2TGenerator``).
``--device`` (``cuda`` by default) is the port's own flag.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np

from avsr_tpu_torch.data import vtt
from avsr_tpu_torch.data.collate import DataCollator
from avsr_tpu_torch.data.norm_text import norm_string
from avsr_tpu_torch.data.tokenizer import TextTransform
from avsr_tpu_torch.data.transforms import (
    AudioTransform,
    RawAudioTransform,
    VideoTransform,
)
from avsr_tpu_torch.data.wer import wer
from avsr_tpu_torch.frontends.cluster import (
    calculate_conversation_scores,
    cluster_speakers,
    get_speaker_activity_segments,
)
from avsr_tpu_torch.frontends.segmentation import asd_chunks, fixed_chunks

LRS2_SETS = [
    "test",
    "test_snr_n5_interferer_1",
    "test_snr_n5_interferer_2",
    "test_snr_0_interferer_1",
    "test_snr_0_interferer_2",
    "test_snr_5_interferer_1",
    "test_snr_5_interferer_2",
    "test_snr_10_interferer_1",
    "test_snr_10_interferer_2",
]
AVCOCKTAIL_SETS = [f"video_{i}" for i in range(0, 51)]
CHUNK_TYPES = ["asd_chunk", "fixed_chunk", "gold_chunk"]
DEFAULT_DIRS = {"avsr_cocktail": "AVSRCocktail", "auto_avsr": "auto_avsr",
                "muavic_en": "AV-HuBERT-MuAViC-en"}


def pad_features(feats, batch_size: int):
    """Collated (audio, video, length) triples -> one fixed batch of
    ``batch_size`` host arrays for the muavic generator; padding rows
    decode one dummy frame."""
    t_max = max(int(n) for _, _, n in feats)
    auds = np.zeros((batch_size, t_max, 104), np.float32)
    vids = np.zeros((batch_size, t_max, 88, 88, 1), np.float32)
    lens = np.ones((batch_size,), np.int64)
    for i, (a, v, n) in enumerate(feats):
        auds[i, :n] = np.asarray(a)[:n]
        vids[i, :n] = np.asarray(v)[:n]
        lens[i] = n
    return auds, vids, lens


class InferenceEngine:
    """Model + collator + batched decode on one device (the reference's
    InferenceEngine)."""

    def __init__(
        self,
        model_type: str = "avsr_cocktail",
        checkpoint_path: Optional[str] = None,
        cache_dir: Optional[str] = None,
        beam_size: int = 3,
        max_length: int = 15,
        batch_size: int = 32,
        mode: str = "beam",
        model_kwargs: Optional[Dict] = None,
        max_decode_tokens: int = 192,
        device: str = "cuda",
    ):
        if model_type not in ("avsr_cocktail", "auto_avsr", "muavic_en"):
            raise ValueError(f"unsupported model type {model_type!r}")
        self.model_type = model_type
        self.checkpoint_path = checkpoint_path
        self.cache_dir = cache_dir or "./model-bin"
        self.beam_size = beam_size
        self.max_length = max_length
        self.batch_size = batch_size
        self.mode = mode
        self.model_kwargs = model_kwargs or {}
        # KV-buffer cap; ~5x any real transcript for <=15s chunks and never
        # binding in practice (0 disables -> reference-exact buffer)
        self.max_decode_tokens = max_decode_tokens or None
        self.device = device
        self.recognizer = None
        self.generator = None
        self.tokenizer = None
        self.text_transform: Optional[TextTransform] = None
        self.collator: Optional[DataCollator] = None

    def load_model(self):
        path = self.checkpoint_path or os.path.join(
            self.cache_dir, DEFAULT_DIRS[self.model_type])
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"checkpoint {path} not found; pass --checkpoint_path pointing "
                "to a local checkpoint (HF-style dir or .pth)"
            )
        if self.model_type == "avsr_cocktail":
            self._load_avsr_cocktail(path)
        elif self.model_type == "auto_avsr":
            self._load_auto_avsr(path)
        else:
            self._load_muavic(path)

    def _load_avsr_cocktail(self, path: str):
        """The JAX engine's defaults: bf16 decoder weights and K|V cache,
        fp32 encoder, delta video wire. The JAX engine's kernel switches
        (``use_flash_attention``, ``decode_fused_attention``) have no
        counterpart: the port always takes its kernels."""
        from avsr_tpu_torch.core.weights import load_released
        from avsr_tpu_torch.decode.recognizer import Recognizer

        self.text_transform = TextTransform()
        self.collator = DataCollator(
            text_transform=self.text_transform,
            # crops ship to the device as uint8; normalization happens there
            video_transform=VideoTransform("test", device_norm=True),
            audio_transform=AudioTransform("test"),
        )
        kw = self.model_kwargs
        cfg, model = load_released(
            path,
            decoder_cache_dtype=kw.get("decoder_cache_dtype", "bfloat16"),
            decoder_param_dtype=kw.get("decoder_param_dtype", "bfloat16"),
        )
        self.recognizer = Recognizer(
            model=model, cfg=cfg,
            beam_size=self.beam_size,
            max_decode_tokens=self.max_decode_tokens,
            video_wire=kw.get("video_wire", "delta"),
            encode_dtype=kw.get("encode_dtype", "float32"),
            device=self.device,
        )
        self._decode_tokens = lambda toks: self.text_transform.post_process(
            toks
        ).replace("<eos>", "")

    def _load_auto_avsr(self, path: str):
        """The JAX engine's auto_avsr loader: ``ConformerAVSR`` built from
        ``model_kwargs`` (``odim`` defaulting to the tokenizer's
        vocabulary), the reference-format state dict at ``path`` loaded
        strictly, float32 frames normalised on the host (the uint8 wire
        codecs do not apply, so ``video_wire`` is dropped) and the raw
        waveform, 640 samples a frame."""
        from avsr_tpu_torch.core.weights import load_state_file
        from avsr_tpu_torch.decode.recognizer import Recognizer
        from avsr_tpu_torch.models.conformer import ConformerAVSR

        self.text_transform = TextTransform()
        self.collator = DataCollator(
            text_transform=self.text_transform,
            video_transform=VideoTransform("test"),
            audio_transform=RawAudioTransform("test"),
        )
        self.model_kwargs.pop("video_wire", None)
        enc_dtype = self.model_kwargs.pop("encode_dtype", "float32")
        model = ConformerAVSR(
            odim=self.model_kwargs.pop("odim", self.text_transform.vocab_size),
            **self.model_kwargs,
        )
        load_state_file(model, path)
        self.recognizer = Recognizer(
            model=model,
            cfg=model,  # gives sos/eos/blank/odim like the dataclass config
            beam_size=self.beam_size,
            audio_rate=640,
            audio_dim=1,
            max_decode_tokens=self.max_decode_tokens,
            encode_dtype=enc_dtype,
            device=self.device,
        )
        self._decode_tokens = lambda toks: self.text_transform.post_process(
            toks
        ).replace("<eos>", "")

    def _load_muavic(self, path: str):
        """The JAX engine's muavic_en loader: ``AV2TextConfig`` from the
        directory's ``config.json`` (its fields only), the state dict
        (``model.``-prefixed keys) loaded strictly, the Speech2Text
        tokenizer, float32 frames normalised on the host, fbank audio, and
        the attention-only ``S2TGenerator``."""
        import dataclasses

        from avsr_tpu_torch.core.weights import load_state_file
        from avsr_tpu_torch.data.s2t_tokenizer import Speech2TextTokenizer
        from avsr_tpu_torch.decode.s2t_generate import S2TGenerator
        from avsr_tpu_torch.models.av2text import AV2TextConfig, AV2TextModel

        cfg_path = os.path.join(path, "config.json")
        kw = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                raw = json.load(f)
            fields = {f.name for f in dataclasses.fields(AV2TextConfig)}
            kw = {k: v for k, v in raw.items() if k in fields}
        model = AV2TextModel(AV2TextConfig(**kw))
        load_state_file(model, path, prefix="model.")
        self.tokenizer = Speech2TextTokenizer.from_pretrained(path)
        self.collator = DataCollator(
            text_transform=None,
            video_transform=VideoTransform("test"),
            audio_transform=AudioTransform("test"),
        )
        self.generator = S2TGenerator(model, beam_size=self.beam_size,
                                      device=self.device)
        self.recognizer = None

    # ---------------- sample preparation ----------------

    def _prepare(self, sample: Dict) -> Dict:
        """Accept {'video': path|bytes, ['audio': wav bytes], [start/end_time]}.

        An optional 'audio' field (wav bytes) becomes a sidecar next to the
        temp mp4 for environments without embedded-audio decode backends.
        """
        video = sample["video"]
        if isinstance(video, (bytes, bytearray)):
            tmp = tempfile.NamedTemporaryFile(suffix=".mp4", delete=False)
            tmp.write(video)
            tmp.close()
            if isinstance(sample.get("audio"), (bytes, bytearray)):
                with open(os.path.splitext(tmp.name)[0] + ".wav", "wb") as f:
                    f.write(sample["audio"])
            sample = dict(sample, video=tmp.name, _tmp=tmp.name)
        return sample

    @staticmethod
    def _segment_context(sample: Dict) -> str:
        ctx = {
            k: (f"<{len(v)} bytes>" if isinstance(v, (bytes, bytearray)) else v)
            for k, v in sample.items()
            if k in ("video", "start_time", "end_time")
        }
        return f"segment {ctx}"

    def _features(self, samples: List[Dict]):
        prepped = [self._prepare(s) for s in samples]
        feats = []
        for s in prepped:
            # per-segment error context so one bad file in a long sweep is
            # attributable (reference script/evaluation.py:290-294,316-320)
            try:
                batch = self.collator([s])
            except Exception as e:
                print(f"Error during inference for {self._segment_context(s)}")
                raise e
            feats.append(
                (batch["audios"][0], batch["videos"][0], batch["video_lengths"][0])
            )
            if "_tmp" in s:
                os.unlink(s["_tmp"])
                sidecar = os.path.splitext(s["_tmp"])[0] + ".wav"
                if os.path.exists(sidecar):
                    os.unlink(sidecar)
        return feats

    def infer_samples(self, samples: List[Dict]) -> List[str]:
        """Decode a list of segment samples; returns transcripts."""
        if self.model_type != "muavic_en":
            return self._infer_samples_pipelined(samples)
        outputs = []
        for lo in range(0, len(samples), self.batch_size):
            chunk = samples[lo : lo + self.batch_size]
            auds, vids, lens = pad_features(self._features(chunk),
                                            self.batch_size)
            try:
                token_batches = self.generator.generate(auds, vids, lens)[
                    : len(chunk)]
            except Exception as e:
                for s in chunk:
                    print(f"Error during inference for "
                          f"{self._segment_context(s)}")
                raise e
            outputs.extend(self.tokenizer.decode(t).upper()
                           for t in token_batches)
        return outputs

    def _infer_samples_pipelined(self, samples: List[Dict]) -> List[str]:
        """A producer thread collates and decodes chunks of ``batch_size``
        segments into a queue of depth 2; this thread copies each result to
        the host and detokenizes it. The beam syncs with the host once
        every ``STOP_EVERY`` steps (``Recognizer.transcribe_batch_async``),
        so the producer's collation of the next chunk overlaps only the
        host work left after a chunk's decode. An error in the producer reaches this thread,
        which names the chunk's segments and raises it.
        """
        chunks = [
            samples[lo : lo + self.batch_size]
            for lo in range(0, len(samples), self.batch_size)
        ]
        staged: "queue.Queue" = queue.Queue(maxsize=2)

        def producer() -> None:
            for chunk in chunks:
                try:
                    feats = self._features(chunk)
                    auds = [
                        np.asarray(a)[: l * self.recognizer.audio_rate]
                        for a, _, l in feats
                    ]
                    vids = [np.asarray(v)[:l] for _, v, l in feats]
                    fut = self.recognizer.transcribe_batch_async(
                        auds, vids, mode=self.mode, batch_pad=self.batch_size
                    )
                except Exception as e:  # attributed + re-raised by the consumer
                    staged.put((None, chunk, e))
                    return
                staged.put((fut, chunk, None))

        worker = threading.Thread(target=producer, daemon=True)
        worker.start()
        outputs: List[str] = []
        for _ in range(len(chunks)):
            fut, chunk, err = staged.get()
            if err is None:
                try:
                    outputs.extend(self._decode_tokens(t) for t in fut.result())
                    continue
                except Exception as e:
                    err = e
            for s in chunk:
                print(f"Error during inference for {self._segment_context(s)}")
            raise err
        worker.join()
        return outputs

    def infer_processed_sample(self, video) -> str:
        return self.infer_samples([{"video": video}])[0]

    # ---------------- chunked long-video inference ----------------

    def chunk_video(self, video_path: str, asd_path: Optional[str] = None):
        if asd_path is not None:
            with open(asd_path) as f:
                asd = json.load(f)
            return asd_chunks(asd, max_length=self.max_length)
        from avsr_tpu_torch.data import media

        wave = media.load_audio(video_path)
        return fixed_chunks(len(wave) / media.SAMPLE_RATE, self.max_length)

    def infer_video(
        self, video_path: str, asd_path: Optional[str] = None, offset: float = 0.0
    ) -> List[Dict]:
        segments = self.chunk_video(video_path, asd_path)
        samples = [
            {"video": video_path, "start_time": s, "end_time": e}
            for s, e in segments
        ]
        texts = self.infer_samples(samples)
        return [
            {"start_time": s + offset, "end_time": e + offset, "text": t}
            for (s, e), t in zip(segments, texts)
        ]

    def mcorec_session_infer(self, session_dir: str, output_dir: str) -> None:
        """Cluster speakers into conversations + produce per-speaker VTTs
        (reference :337-385)."""
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(session_dir, "metadata.json")) as f:
            metadata = json.load(f)

        speaker_segments = {}
        for name, data in metadata.items():
            asd_paths = [
                os.path.join(session_dir, track["asd"])
                for track in data["central"]["crops"]
            ]
            uem = data["central"]["uem"]
            speaker_segments[name] = get_speaker_activity_segments(
                asd_paths, uem["start"], uem["end"]
            )
        scores = calculate_conversation_scores(speaker_segments)
        clusters = cluster_speakers(scores, list(speaker_segments))
        with open(os.path.join(output_dir, "speaker_to_cluster.json"), "w") as f:
            json.dump(clusters, f, indent=4)

        for name, data in metadata.items():
            hyps: List[Dict] = []
            for track in data["central"]["crops"]:
                video_path = os.path.join(session_dir, track["lip"])
                asd_path = (
                    os.path.join(session_dir, track["asd"]) if "asd" in track else None
                )
                with open(os.path.join(session_dir, track["crop_metadata"])) as f:
                    crop_meta = json.load(f)
                hyps.extend(
                    self.infer_video(video_path, asd_path, crop_meta["start_time"])
                )
            cues = [
                vtt.Cue(h["start_time"], h["end_time"],
                        h["text"].strip().replace("<unk>", "").strip())
                for h in hyps
            ]
            with open(os.path.join(output_dir, f"{name}.vtt"), "w") as f:
                f.write(vtt.write(cues))


def eval_lrs2(engine: InferenceEngine, dataset, verbose: bool = False) -> float:
    refs, hyps = [], []
    samples, labels = [], []
    for sample in dataset:
        label = sample["label"]
        if isinstance(label, bytes):
            label = label.decode("utf-8")
        labels.append(norm_string(label.replace("<unk>", "")))
        s = {"video": sample["video"]}
        if "audio" in sample:
            s["audio"] = sample["audio"]
        samples.append(s)
    outputs = engine.infer_samples(samples)
    hyps = [norm_string(o.replace("<unk>", "")) for o in outputs]
    refs = labels
    if verbose:
        for i, (r, h) in enumerate(zip(refs, hyps)):
            print(f"[{i}] REF: {r}")
            print(f"[{i}] HYP: {h} (wer {wer(reference=r or '<empty>', hypothesis=h):.4f})")
    return wer(reference=refs, hypothesis=hyps)


def eval_avcocktail(engine, video_dataset, label_dataset, set_name=None,
                    verbose: bool = False):
    label_blob = label_dataset["label"][0]
    if isinstance(label_blob, bytes):
        label_blob = label_blob.decode("utf-8")
    cues = [c for c in vtt.parse(label_blob) if c.text]
    cues.sort(key=lambda c: c.start)
    if not cues:
        raise ValueError("no labels parsed")
    start_time = min(c.start for c in cues)
    end_time = max(c.end for c in cues)
    label_text = norm_string(" ".join(c.text for c in cues))

    wer_scores = {}
    for chunk_type in CHUNK_TYPES:
        picked = []
        for sample in video_dataset[chunk_type]:
            s = float(sample["start_time"]) if not isinstance(
                sample["start_time"], bytes
            ) else float(sample["start_time"].decode())
            e = float(sample["end_time"]) if not isinstance(
                sample["end_time"], bytes
            ) else float(sample["end_time"].decode())
            if s + 1 < start_time or e - 1 > end_time:
                continue
            picked.append((s, {"video": sample["video"]}))
        picked.sort(key=lambda p: p[0])
        outputs = engine.infer_samples([p[1] for p in picked])
        if verbose:
            for (s, _), o in zip(picked, outputs):
                print(f"[{set_name or ''} {chunk_type} @{s:.2f}s] HYP: {o}")
        output_text = norm_string(" ".join(outputs).replace("<unk>", ""))
        wer_scores[chunk_type] = wer(reference=label_text, hypothesis=output_text)
    return wer_scores, len(label_text.split())


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Unified inference for AVSR models (PyTorch, CUDA)"
    )
    parser.add_argument(
        "--model_type", type=str, default="avsr_cocktail",
        choices=["avsr_cocktail", "auto_avsr", "muavic_en"],
    )
    parser.add_argument(
        "--dataset_name", type=str, default="lrs2", choices=["lrs2", "AVCocktail"]
    )
    parser.add_argument(
        "--set_id", type=str, default="*",
        choices=LRS2_SETS + AVCOCKTAIL_SETS + ["*"],
    )
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--cache_dir", type=str, default="./model-bin")
    parser.add_argument("--max_length", type=int, default=15)
    parser.add_argument("--beam_size", type=int, default=3)
    parser.add_argument("--max_decode_tokens", type=int, default=192,
                        help="self-KV buffer cap in tokens (0 = uncapped, "
                        "reference-exact frame-count-sized buffer)")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="segments decoded together")
    parser.add_argument("--video_wire", type=str, default="delta",
                        choices=["delta", "delta2", "uint8"],
                        help="crop upload codec: lossless temporal delta, "
                             "delta + zigzag nibble-plane pack (see "
                             "data/wire.py), or raw uint8")
    parser.add_argument("--decode_mode", type=str, default="beam",
                        choices=["beam", "greedy"])
    parser.add_argument("--encode_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="encoder forward dtype at decode time; the beam "
                             "math stays fp32")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--output_dir_name", type=str, default="output")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the model (cpu for the CPU)")
    return parser


def _load_hf_dataset(name: str, config: str, **kw):
    import datasets

    return datasets.load_dataset(name, config, cache_dir="./data-bin/cache", **kw)


def main():
    args = build_parser().parse_args()
    engine = InferenceEngine(
        args.model_type,
        args.checkpoint_path,
        args.cache_dir,
        args.beam_size,
        args.max_length,
        args.batch_size,
        args.decode_mode,
        max_decode_tokens=args.max_decode_tokens,
        model_kwargs={"video_wire": args.video_wire,
                      "encode_dtype": args.encode_dtype},
        device=args.device,
    )
    engine.load_model()

    if args.dataset_name == "lrs2":
        sets = LRS2_SETS if args.set_id == "*" else [args.set_id]
        scores = []
        for set_id in sets:
            print(f"Inferring lrs2/{set_id} sessions using {args.model_type} model")
            ds = _load_hf_dataset("nguyenvulebinh/AVYT", "lrs2", streaming=True)[set_id]
            score = eval_lrs2(engine, ds, verbose=args.verbose)
            scores.append(score)
            print(f"WER {set_id}: {score:.4f}")
        if len(sets) > 1:
            print(f"Average WER: {sum(scores) / len(scores):.4f}")
    else:
        sets = AVCOCKTAIL_SETS if args.set_id == "*" else [args.set_id]
        agg: Dict[str, List[float]] = {}
        for set_id in sets:
            print(f"Inferring AVCocktail/{set_id} sessions using {args.model_type} model")
            video_ds = _load_hf_dataset("nguyenvulebinh/AVCocktail", set_id)
            label_ds = _load_hf_dataset("nguyenvulebinh/AVCocktail", "labels")[set_id]
            wer_scores, n_words = eval_avcocktail(
                engine, video_ds, label_ds, set_id, verbose=args.verbose
            )
            for chunk_type, score in wer_scores.items():
                agg.setdefault(chunk_type, []).extend([score] * n_words)
                print(f"WER {set_id} {chunk_type}: {score:.4f}")
        if len(sets) > 1:
            for chunk_type, scores in agg.items():
                print(f"Average WER {chunk_type}: {sum(scores) / len(scores):.4f}")


if __name__ == "__main__":
    main()
