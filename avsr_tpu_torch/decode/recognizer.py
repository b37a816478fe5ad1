"""End-to-end recognizer: features -> encoder -> joint CTC/attention beam
-> tokens.

Counterpart of ``avsr_tpu/decode/recognizer.py`` on one device, with the
same defaults (beam 3, ``ctc_weight=0.1``, unfused bookkeeping). It serves
any model family with ``encode(audios, videos, lengths)``,
``ctc_log_probs``, ``decoder_init`` and ``decoder_step``, and ``cfg``
giving ``sos``, ``eos``, ``blank`` and ``odim`` (the AV-HuBERT model with
its config; a conformer model is its own ``cfg``, as in the JAX package).
Utterances are padded into static (batch, frames) buckets, the audio as
``audio_rate`` rows of ``audio_dim`` a video frame (fbank features 1 x 104,
or the raw waveform 640 x 1); uint8 crops travel to the device delta-coded
(``data/wire.py``) and are decoded and normalised there, float32 frames
(normalised on the host) as they are; the encoder runs as one batch (in
bf16 when ``encode_dtype="bfloat16"``, on a copy of the model without its
decoder, every float weight and BN statistic cast); the beam decodes all
utterances of the batch together, reading its stop flag once every
``device_loop.STOP_EVERY`` steps and on the card replaying those steps as
a CUDA graph (``device_loop=False`` is the host loop, a read every
step). ``mode="greedy"`` is greedy CTC. It runs on the card unless
``device`` says otherwise.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from avsr_tpu_torch.data import wire
from avsr_tpu_torch.decode.beam import (
    BeamSearchConfig,
    beam_search_batched,
    greedy_ctc,
)
from avsr_tpu_torch.ops.cpu import warm_exp


def pick_bucket(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"utterance of {n} frames exceeds largest bucket {buckets[-1]}")


@dataclass
class Recognizer:
    model: torch.nn.Module  # AVSRModel, ConformerAVSR
    cfg: object  # AVHubertAVSRConfig, or the conformer model itself
    beam_size: int = 3
    ctc_weight: float = 0.1
    t_buckets: Sequence[int] = (96, 192, 288, 384)
    # audio layout per video frame: fbank features (1 x 104) for the
    # AV-HuBERT family, raw waveform (640 x 1) for the conformer family
    audio_rate: int = 1
    audio_dim: int = 104
    # self-KV buffer cap in tokens (None = frame-count-sized buffer)
    max_decode_tokens: Optional[int] = None
    # encoder forward dtype: "float32" or "bfloat16"
    encode_dtype: str = "float32"
    # uint8 video transfer codec: "uint8", "delta" or "delta2"
    video_wire: str = "delta"
    # the beam step's bookkeeping as one beam_update kernel launch
    fused_bookkeeping: bool = False
    # the beam's device loop (decode/device_loop.py): a stop read every
    # STOP_EVERY steps, the steps between as one CUDA graph replay on the
    # card; False runs the host loop (a read every step, no graph)
    device_loop: bool = True
    device: str = "cuda"
    _encoder: torch.nn.Module = field(init=False, repr=False)

    def __post_init__(self):
        if self.encode_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"encode_dtype {self.encode_dtype!r}")
        if self.video_wire not in ("uint8", "delta", "delta2"):
            raise ValueError(f"video_wire {self.video_wire!r}")
        self.device = torch.device(self.device)
        if self.device.type == "cpu":
            warm_exp()
        self.model = self.model.to(self.device).eval()
        self._encoder = self.model
        if self.encode_dtype == "bfloat16":
            # a bf16 copy of the model without its decoder (an empty module
            # stands in): every float weight and BN statistic of the encoder
            # side is cast (fp32 statistics would re-promote the trunk's
            # activations); the decoder keeps the fp32 weights and casts
            # them itself to its parameter dtype
            memo = {id(self.model.decoder): torch.nn.Module()}
            self._encoder = copy.deepcopy(self.model, memo).to(torch.bfloat16)

    @classmethod
    def from_pretrained(cls, model_dir: str, **kw) -> "Recognizer":
        from avsr_tpu_torch.core.weights import load_released

        cfg, model = load_released(model_dir)
        return cls(model=model, cfg=cfg, **kw)

    # ---------------- stages ----------------

    @torch.inference_mode()
    def encode(self, aud, vid, lens):
        """Padded device batch -> (feats (B,T,D) fp32, CTC log-probs fp32)."""
        if vid.dtype == torch.uint8:
            if self.video_wire == "delta":
                vid = wire.delta_decode_video(vid)
            elif self.video_wire == "delta2":
                vid = wire.delta2_decode_video(vid)
            vid = (vid.float() / 255.0 - wire.VIDEO_MEAN) / wire.VIDEO_STD
        dt = getattr(torch, self.encode_dtype)
        feats = self._encoder.encode(aud.to(dt), vid.to(dt), lens)
        return feats.float(), self._encoder.ctc_log_probs(feats)

    def beam_config(self) -> BeamSearchConfig:
        return BeamSearchConfig(
            beam_size=self.beam_size, ctc_weight=self.ctc_weight,
            sos=self.cfg.sos, eos=self.cfg.eos, blank=self.cfg.blank,
            vocab=self.cfg.odim, max_decode_tokens=self.max_decode_tokens,
            fused_bookkeeping=self.fused_bookkeeping,
            # both decoder families fold the beam lanes into the
            # cross-attention query and resolve ancestry at attention time
            shared_src_kv=True, lazy_reorder=True,
        )

    @torch.inference_mode()
    def beam(self, feats, ctc_logp, lens):
        """Encoder features and CTC log-probs (``encode``'s outputs) ->
        (yseqs (B, L), lengths (B,), scores (B,)) on the device."""
        m = self.model
        return beam_search_batched(self.beam_config(), m.decoder_step,
                                   m.decoder_init, feats, ctc_logp, lens,
                                   device_loop=self.device_loop)

    # ---------------- host-side batching ----------------

    def _pad_batch(self, audio_feats: List[np.ndarray],
                   videos: List[np.ndarray], batch_pad: Optional[int] = None):
        lengths = np.asarray([len(v) for v in videos], np.int64)
        t_b = pick_bucket(self.t_buckets, int(lengths.max()))
        b = batch_pad or len(videos)
        vdtype = np.uint8 if videos[0].dtype == np.uint8 else np.float32
        aud = np.zeros((b, t_b * self.audio_rate, self.audio_dim), np.float32)
        vid = np.zeros((b, t_b, 88, 88, 1), vdtype)
        for i, (a, v) in enumerate(zip(audio_feats, videos)):
            a = a.reshape(-1, self.audio_dim)
            aud[i, : len(a)] = a
            vid[i, : len(v)] = v
        lens = np.zeros((b,), np.int64)
        lens[: len(videos)] = lengths
        lens[len(videos):] = 1  # padded rows decode one dummy frame
        if vdtype == np.uint8 and self.video_wire == "delta":
            vid = wire.delta_encode_video(vid)
        elif vdtype == np.uint8 and self.video_wire == "delta2":
            vid = wire.delta2_encode_video(vid)
        aud_t = torch.from_numpy(aud)
        if self.encode_dtype == "bfloat16":
            # the encoder casts to bf16 anyway: upload half the bytes
            aud_t = aud_t.to(torch.bfloat16)
        dev = self.device
        return (aud_t.to(dev), torch.from_numpy(vid).to(dev),
                torch.from_numpy(lens).to(dev), len(videos))

    def transcribe_batch_async(self, audio_feats: List[np.ndarray],
                               videos: List[np.ndarray], mode: str = "beam",
                               batch_pad: Optional[int] = None
                               ) -> "_PendingBatch":
        """Encode and decode a batch; the pending batch's ``result()``
        copies the tokens to the host and strips them.

        The JAX package's counterpart returns as soon as the work is
        dispatched. Here the beam loop reads its stop flag from the device
        once every ``STOP_EVERY`` steps, so the decode has run when this
        returns; only the copy to the host is left for ``result()``. The call sets the
        current CUDA device to the recognizer's, so a thread other than
        the one that built it can call it."""
        if mode not in ("beam", "greedy"):
            raise ValueError(f"mode {mode!r}")
        on_device = (torch.cuda.device(self.device)
                     if self.device.type == "cuda"
                     else contextlib.nullcontext())
        with on_device:
            aud, vid, lens, n = self._pad_batch(audio_feats, videos,
                                                batch_pad)
            feats, ctc_logp = self.encode(aud, vid, lens)
            if mode == "greedy":
                return _PendingBatch(self, "greedy", n, greedy_ctc(
                    ctc_logp, lens, blank=self.cfg.blank))
            return _PendingBatch(self, "beam", n,
                                 self.beam(feats, ctc_logp, lens)[:2])

    def transcribe_batch(self, audio_feats: List[np.ndarray],
                         videos: List[np.ndarray], mode: str = "beam",
                         batch_pad: Optional[int] = None) -> List[np.ndarray]:
        """Decode a batch; returns per-utterance token ids (no sos/eos)."""
        return self.transcribe_batch_async(audio_feats, videos, mode,
                                           batch_pad).result()

    def transcribe(self, audio_feats: np.ndarray, video: np.ndarray,
                   mode: str = "beam") -> np.ndarray:
        return self.transcribe_batch([audio_feats], [video], mode=mode)[0]


class _PendingBatch:
    """A decoded batch on the device; ``result()`` copies and strips it."""

    def __init__(self, rec: Recognizer, mode: str, n: int, tensors):
        self.rec = rec
        self.mode = mode
        self.n = n
        self.tensors = tensors

    def result(self) -> List[np.ndarray]:
        toks, lens = (x.cpu().numpy() for x in self.tensors)
        if self.mode == "greedy":
            return [toks[i, : lens[i]] for i in range(self.n)]
        out = []
        for i in range(self.n):
            seq = toks[i, 1: lens[i]]  # strip sos
            out.append(seq[seq != self.rec.cfg.eos])  # strip eos
        return out
