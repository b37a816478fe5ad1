"""End-to-end AVSR model: AV-HuBERT encoder + CTC head + attention decoder.

Counterpart of ``avsr_tpu/models/e2e.py``: the training forward with the
joint loss mtlalpha * CTC + (1 - mtlalpha) * label-smoothed CE and token
accuracy (reference e2e_asr_avhubert.py:24-159), and the inference
methods the Recognizer uses. Module names follow the reference
checkpoint's keys (``encoder.*``, ``ctc.ctc_lo``, ``decoder.*``,
``proj_decoder``), so ``core/weights.py`` loads a state dict strictly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from avsr_tpu_torch.core.config import AVHubertAVSRConfig
from avsr_tpu_torch.models.avhubert import AVHubertModel
from avsr_tpu_torch.models.decoder import DecoderCache, TransformerDecoder
from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.ctc import ctc_loss, label_smoothing_loss, th_accuracy
from avsr_tpu_torch.ops.dropout import DropoutRng, dropout
from avsr_tpu_torch.ops.masks import (add_sos_eos, make_non_pad_mask,
                                      target_mask)


class AVSROutput(NamedTuple):
    loss: torch.Tensor
    loss_ctc: torch.Tensor
    loss_att: torch.Tensor
    acc: torch.Tensor


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
                dropout=cfg.dropout_rate,
                attn_dropout=cfg.transformer_attn_dropout_rate,
                cache_dtype=cfg.decoder_cache_dtype,
                param_dtype=cfg.decoder_param_dtype,
                fused_layer=cfg.decode_fused_layer,
            )
        if cfg.adim != cfg.ddim:
            # part of the checkpoint; applied by the training forward only,
            # as in the JAX package's decode path
            self.proj_decoder = nn.Linear(cfg.adim, cfg.ddim)

    def forward(self, videos: torch.Tensor, audios: torch.Tensor,
                labels: torch.Tensor, video_lengths: torch.Tensor,
                label_lengths: torch.Tensor, train: bool = False,
                rng: Optional[DropoutRng] = None) -> AVSROutput:
        """Losses and accuracy of videos (B, T, 88, 88, 1), audios
        (B, T, 104), labels (B, L) padded with -1, lengths (B,).
        ``train=True`` needs ``rng`` (dropouts, modality dropout) and
        updates the BatchNorm running statistics."""
        c = self.cfg
        if videos.device.type == "cpu":
            warm_exp()  # a caller of the modules themselves (ROADMAP C21)
        pad_mask = make_non_pad_mask(video_lengths, videos.shape[1])
        x = self.encoder(audios, videos, pad_mask, train, rng)
        rng = rng if train else None
        ctc_logits = self.ctc.ctc_lo(dropout(x, c.dropout_rate, rng))
        loss_ctc = ctc_loss(ctc_logits, video_lengths, labels, label_lengths,
                            blank_id=c.blank)
        if c.adim != c.ddim:
            x = self.proj_decoder(x)
        ys_in, ys_out = add_sos_eos(labels, label_lengths, c.sos, c.eos,
                                    c.ignore_id)
        pred = self.decoder(ys_in, target_mask(ys_in, c.ignore_id), x,
                            pad_mask[:, None, :], rng)
        loss_att = label_smoothing_loss(
            pred, ys_out, c.lsm_weight, c.ignore_id,
            c.transformer_length_normalized_loss)
        loss = c.mtlalpha * loss_ctc + (1 - c.mtlalpha) * loss_att
        acc = th_accuracy(pred, ys_out, c.ignore_id)
        return AVSROutput(loss, loss_ctc, loss_att, acc)

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

    def decoder_step(self, y_t, pos, cache: DecoderCache,
                     memory_mask=None, lane_bias=None):
        return self.decoder.step(y_t, pos, cache, memory_mask, lane_bias)
