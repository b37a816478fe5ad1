"""Generation for the AV2Text (MuAViC) seq2seq family.

Counterpart of ``avsr_tpu/decode/s2t_generate.py``: the encoder, then the
batched beam of ``decode/beam.py`` with attention-only scoring
(``ctc_weight=0``, so no CTC log-probs are made) on its eager path, the
JAX defaults: the memory repeated to B*K lanes, the self caches gathered
by each successor's parent after the selection. sos is
``decoder_start_token_id``, eos ``eos_token_id``; the self-K/V buffer is
the frame count plus 2, rounded up to 64 (no cap). The beam runs in its
device loop (a stop read every ``STOP_EVERY`` steps, the steps between as
one CUDA graph replay on the card) unless ``device_loop=False`` asks for
the host loop. Runs under ``torch.inference_mode()`` on ``device`` (the
card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from avsr_tpu_torch.decode.beam import BeamSearchConfig, beam_search_batched
from avsr_tpu_torch.models.av2text import AV2TextModel
from avsr_tpu_torch.ops.cpu import warm_exp


class S2TGenerator:
    def __init__(self, model: AV2TextModel, beam_size: int = 3,
                 device: str = "cuda", device_loop: bool = True):
        cfg = model.cfg
        self.device = torch.device(device)
        self.device_loop = device_loop
        if self.device.type == "cpu":
            warm_exp()
        self.model = model.to(self.device).eval()
        self.bcfg = BeamSearchConfig(
            beam_size=beam_size,
            ctc_weight=0.0,
            sos=cfg.decoder_start_token_id,
            eos=cfg.eos_token_id,
            blank=cfg.pad_token_id,  # unused (ctc off)
            vocab=cfg.vocab_size,
        )

    @torch.inference_mode()
    def encode(self, audios, videos, lengths) -> torch.Tensor:
        """Host or device arrays -> encoder features (B, T, D) on the
        device."""
        dev = self.device
        return self.model.encode(torch.as_tensor(audios, device=dev),
                                 torch.as_tensor(videos, device=dev),
                                 torch.as_tensor(lengths, device=dev).long())

    @torch.inference_mode()
    def beam(self, memory, lengths):
        """Encoder features -> (yseqs (B, L), lengths (B,), scores (B,)) on
        the device."""
        m = self.model
        return beam_search_batched(
            self.bcfg, m.decoder_step, m.decoder_init, memory, None,
            torch.as_tensor(lengths).long(), device_loop=self.device_loop)

    def generate(self, audios, videos, lengths) -> List[np.ndarray]:
        """Returns per-utterance token ids (sos/eos stripped)."""
        yseqs, ylens, _ = self.beam(self.encode(audios, videos, lengths),
                                    lengths)
        yseqs, ylens = yseqs.cpu().numpy(), ylens.cpu().numpy()
        out = []
        eos = self.bcfg.eos
        for i in range(len(yseqs)):
            seq = yseqs[i, 1: ylens[i]]
            out.append(seq[seq != eos])
        return out
