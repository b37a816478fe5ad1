"""End-to-end AVSR model: AV-HuBERT encoder + CTC head + attention decoder.

Counterpart of ``avsr_tpu/models/e2e.py:32-97`` (inference methods; the
training losses are not ported yet). Module names follow the reference
checkpoint's keys (``encoder.*``, ``ctc.ctc_lo``, ``decoder.*``,
``proj_decoder``), so ``core/weights.py`` loads a state dict strictly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avsr_tpu_torch.core.config import AVHubertAVSRConfig
from avsr_tpu_torch.models.avhubert import AVHubertModel
from avsr_tpu_torch.models.decoder import DecoderCache, TransformerDecoder
from avsr_tpu_torch.ops.masks import make_non_pad_mask


class _CTCHead(nn.Module):
    def __init__(self, dim: int, odim: int):
        super().__init__()
        self.ctc_lo = nn.Linear(dim, odim)


class AVSRModel(nn.Module):
    def __init__(self, cfg: AVHubertAVSRConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = AVHubertModel(cfg.encoder)
        self.ctc = _CTCHead(cfg.adim, cfg.odim)
        if cfg.mtlalpha < 1:
            self.decoder = TransformerDecoder(
                odim=cfg.odim, dim=cfg.ddim, heads=cfg.dheads,
                units=cfg.dunits, layers=cfg.dlayers,
                cache_dtype=cfg.decoder_cache_dtype,
                param_dtype=cfg.decoder_param_dtype,
            )
        if cfg.adim != cfg.ddim:
            # part of the checkpoint; applied by the training forward only,
            # as in the JAX package's decode path
            self.proj_decoder = nn.Linear(cfg.adim, cfg.ddim)

    def encode(self, audio: Optional[torch.Tensor],
               video: Optional[torch.Tensor],
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = (video if video is not None else audio).shape[1]
        mask = make_non_pad_mask(lengths, t) if lengths is not None else None
        return self.encoder(audio, video, mask)

    def ctc_log_probs(self, feats: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.ctc.ctc_lo(feats).float(), dim=-1)

    def decoder_init(self, memory: torch.Tensor, maxlen: int,
                     beam: int = 1) -> DecoderCache:
        return self.decoder.init_cache(memory, maxlen, beam)

    def decoder_step(self, y_t, pos: int, cache: DecoderCache,
                     memory_mask=None, lane_bias=None):
        return self.decoder.step(y_t, pos, cache, memory_mask, lane_bias)
