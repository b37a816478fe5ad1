"""AV-HuBERT masked-prediction pretraining objective.

Counterpart of ``avsr_tpu/train/pretrain.py``, the CLI's ``--pretrain``:
input span masks sampled on the host (``ops/span_mask.py``), the
'same_seq' video corruption as a (B, T) gather map, the port's
``AVHubertModel`` under the name ``hubert`` (the fine-tuning encoder's
layout, so a pretraining run's ``hubert.*`` weights load into
``AVSRModel.encoder``: ``encoder_state``), a GradMultiply on the
features, a projection to ``final_dim``, cosine logits against learned
cluster embeddings at ``logit_temp``, and the HuBERT criterion
(masked/unmasked cross-entropy plus a feature penalty) with its five
metrics. Defaults mirror configuration_avhubert_avsr.py:113-187.

Under data parallelism the criterion's masked and unmasked position
counts are the global batch's (summed over the ranks without gradient),
so the mean over ranks of the ranks' losses, and of their gradients, is
the JAX package's loss over the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.core import dist
from avsr_tpu_torch.core.config import AVHubertEncoderConfig
from avsr_tpu_torch.models.avhubert import AVHubertModel
from avsr_tpu_torch.ops.dropout import DropoutRng
from avsr_tpu_torch.ops.span_mask import compute_mask_indices

METRICS = ("loss", "loss_m", "loss_u", "feature_pen", "acc_m")


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    mask_prob_audio: float = 0.8
    mask_length_audio: int = 10
    mask_prob_image: float = 0.3
    mask_length_image: int = 5
    final_dim: int = 256
    num_classes: int = 2004
    logit_temp: float = 0.1
    sim_type: str = "cosine"  # 'cosine' | 'dot'
    feature_grad_mult: float = 0.1
    pred_masked_weight: float = 1.0
    pred_nomask_weight: float = 0.0
    feature_pen_weight: float = 0.0


def sample_pretrain_masks(
    cfg: PretrainConfig,
    batch: int,
    frames: int,
    lengths: Optional[np.ndarray] = None,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side draw of (audio_mask, video_mask, video_src_index):
    video_src_index is the identity on unmasked frames and on masked ones
    a uniformly drawn other frame of the same sequence ('same_seq')."""
    rng = rng or np.random.RandomState()
    pad = None
    if lengths is not None:
        pad = np.arange(frames)[None, :] >= np.asarray(lengths)[:, None]
    a_mask = compute_mask_indices(
        (batch, frames), pad, cfg.mask_prob_audio, cfg.mask_length_audio,
        min_masks=2, rng=rng,
    )
    v_mask = compute_mask_indices(
        (batch, frames), pad, cfg.mask_prob_image, cfg.mask_length_image,
        min_masks=2, rng=rng,
    )
    src = np.tile(np.arange(frames, dtype=np.int32), (batch, 1))
    for b in range(batch):
        sz = frames if lengths is None else int(lengths[b])
        idx = np.where(v_mask[b])[0]
        if len(idx) and sz > 1:
            others = rng.randint(0, sz - 1, size=len(idx))
            others += others >= idx  # never map a frame onto itself
            src[b, idx] = np.minimum(others, sz - 1)
    return a_mask, v_mask, src


class _GradMultiply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def grad_multiply(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x in the forward; the gradient scaled by ``scale`` in the backward."""
    return _GradMultiply.apply(x, scale)


def _global_count(c: torch.Tensor) -> torch.Tensor:
    """A position count over the global batch (no gradient): summed over
    the data group, whose ranks hold the batch's shards."""
    return dist.all_reduce_sum(c.detach().float())


class AVHubertPretrainModel(nn.Module):
    """AVHubertModel (``hubert``) + mask embedding + projection and
    cluster-embedding head. ``forward(audio (B,T,104), video
    (B,T,88,88,1), audio_mask (B,T) True = masked, video_src_index (B,T),
    targets (B,T), padding_mask (B,T) True = valid | None, train, rng)``
    -> (loss, metrics)."""

    def __init__(self, encoder_cfg: AVHubertEncoderConfig,
                 cfg: Optional[PretrainConfig] = None):
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.pretrain_cfg = cfg = cfg or PretrainConfig()
        self.mask_emb = nn.Parameter(torch.zeros(encoder_cfg.audio_feat_dim))
        self.hubert = AVHubertModel(encoder_cfg)
        self.final_proj = nn.Linear(encoder_cfg.encoder_embed_dim,
                                    cfg.final_dim)
        self.label_embs = nn.Parameter(torch.zeros(cfg.num_classes,
                                                   cfg.final_dim))

    def forward(self, audio, video, audio_mask, video_src_index, targets,
                padding_mask=None, train: bool = True,
                rng: Optional[DropoutRng] = None):
        c = self.pretrain_cfg
        b, t = audio.shape[:2]
        audio_m = torch.where(audio_mask[..., None],
                              self.mask_emb.to(audio.dtype), audio)
        rows = torch.arange(b, device=video.device)[:, None]
        video_m = video[rows, video_src_index]
        frames = torch.arange(t, device=video.device)[None, :]
        video_mask = video_src_index != frames

        feats = self.hubert(audio_m, video_m, padding_mask, train, rng)
        if c.feature_grad_mult != 1.0:
            feats = grad_multiply(feats, c.feature_grad_mult)
        proj = self.final_proj(feats)  # (B, T, F)
        embs = self.label_embs
        if c.sim_type == "cosine":
            proj = proj / torch.linalg.vector_norm(
                proj, dim=-1, keepdim=True).clamp_min(1e-6)
            embs = embs / torch.linalg.vector_norm(
                embs, dim=-1, keepdim=True).clamp_min(1e-6)
        logits = (proj @ embs.t() / c.logit_temp).float()  # (B, T, V)

        mask_any = audio_mask | video_mask
        valid = (padding_mask if padding_mask is not None
                 else torch.ones_like(audio_mask))
        logp = F.log_softmax(logits, dim=-1)
        tgt_logp = logp.gather(-1, targets[..., None].long())[..., 0]
        m_sel = mask_any & valid
        u_sel = ~mask_any & valid
        world = dist.data_size()
        m_cnt = _global_count(m_sel.sum()).clamp_min(1)
        u_cnt = _global_count(u_sel.sum()).clamp_min(1)
        zero = tgt_logp.new_zeros(())
        loss_m = -torch.where(m_sel, tgt_logp, zero).sum() / m_cnt * world
        loss_u = -torch.where(u_sel, tgt_logp, zero).sum() / u_cnt * world
        feature_pen = feats.float().pow(2).mean()
        loss = (c.pred_masked_weight * loss_m
                + c.pred_nomask_weight * loss_u
                + c.feature_pen_weight * feature_pen)
        hits = (m_sel & (logits.argmax(-1) == targets)).sum()
        acc_m = hits.float() / m_cnt * world
        return loss, {"loss": loss, "loss_m": loss_m, "loss_u": loss_u,
                      "feature_pen": feature_pen, "acc_m": acc_m}


@torch.no_grad()
def init_pretrain_weights(model: AVHubertPretrainModel,
                          generator: torch.Generator) -> AVHubertPretrainModel:
    """``core/weights.init_weights`` for the modules, and U[0, 1) (flax
    ``uniform(scale=1.0)``) for ``mask_emb`` and ``label_embs``."""
    from avsr_tpu_torch.core.weights import init_weights

    init_weights(model, generator)
    for p in (model.mask_emb, model.label_embs):
        p.copy_(torch.rand(p.shape, generator=generator,
                           device=generator.device))
    return model


def encoder_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A pretraining state dict's ``hubert.*`` entries under the names of
    ``AVSRModel``'s encoder (``encoder.*``): the fine-tuning handoff."""
    return {"encoder." + k[len("hubert."):]: v for k, v in state.items()
            if k.startswith("hubert.")}


class PretrainCollator:
    """Pretraining batches: the fine-tuning collation (media decode,
    augmentation, fbank) plus host-side mask sampling and frame-level
    cluster targets: a sample's ``cluster_targets`` where the dataset ships
    k-means labels, else a fixed random projection of the frame features
    argmaxed over ``num_classes`` (a learnable proxy for offline runs)."""

    def __init__(self, base, cfg: Optional[PretrainConfig] = None,
                 seed: int = 0):
        self.base = base
        self.cfg = cfg or PretrainConfig()
        self.seed = seed
        self.t_buckets = None
        self.l_buckets = None
        self._proj: Optional[np.ndarray] = None

    def __call__(self, features, group_index=None):
        self.base.t_buckets = self.t_buckets
        self.base.l_buckets = self.l_buckets
        batch = self.base(features, group_index=group_index)
        b, t = batch["videos"].shape[:2]
        lengths = batch["video_lengths"]
        seed = self.seed
        if group_index is not None:
            seed = (seed + 77_003 * (group_index + 1)) % (2**31)
        rng = np.random.RandomState(seed)
        a_mask, v_mask, src = sample_pretrain_masks(
            self.cfg, b, t, lengths, rng
        )
        if "cluster_targets" in features[0]:
            targets = np.zeros((b, t), np.int32)
            for i, f in enumerate(features):
                ct = np.asarray(f["cluster_targets"], np.int32)[:t]
                targets[i, : len(ct)] = ct
        else:
            aud = batch["audios"]
            rate = max(1, aud.shape[1] // t)
            frame = aud[:, : t * rate].reshape(b, t, -1)
            if self._proj is None or self._proj.shape[0] != frame.shape[-1]:
                pr = np.random.RandomState(12_345)
                self._proj = pr.randn(
                    frame.shape[-1], self.cfg.num_classes
                ).astype(np.float32)
            targets = np.argmax(frame @ self._proj, axis=-1).astype(np.int32)
        return {
            "videos": batch["videos"],
            "audios": batch["audios"],
            "video_lengths": lengths,
            "audio_mask": a_mask,
            "video_src_index": src,
            "targets": targets,
        }
