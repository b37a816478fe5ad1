"""AV-HuBERT encoder: modality feature extractors + fusion + transformer.

Counterpart of ``avsr_tpu/models/avhubert.py``:

  audio (B,T,104) -> Linear -> (B,T,D)
  video (B,T,88,88,1) -> ResEncoder -> Linear -> (B,T,D)
  [train: whole-batch modality dropout]
  concat -> LayerNorm(2D) -> Linear(2D->D) -> dropout
  -> weight-norm grouped conv positional embedding -> dropout
  -> N pre-LN layers -> final LayerNorm

Self-attention always runs through the flash-attention wrapper
(``ops/kernels/flash_attention.mha_flash``): the hand-written kernels on the
GPU, their plain twins on the CPU; in training its attention-prob dropout
is drawn inside the kernels. ``train=True`` takes a ``DropoutRng`` for every
dropout and switches the frontend's BatchNorms to batch statistics. The
config's ``scan_remat`` and ``frontend_remat`` rematerialise the encoder
layers and the video frontend in the backward (``models/remat.py``);
``scan_unroll``, an XLA scan knob, has no counterpart. Module names follow
the reference checkpoint.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.core import tensor_parallel as tp
from avsr_tpu_torch.core.config import AVHubertEncoderConfig
from avsr_tpu_torch.models import remat
from avsr_tpu_torch.models.resnet import ResEncoder
from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.dropout import DropoutRng, dropout
from avsr_tpu_torch.ops.kernels.flash_attention import mha_flash


class _WeightNormConv1d(nn.Module):
    """Grouped Conv1d with weight norm over dims (0, 1), stored in torch's
    weight-norm layout: weight_g (1, 1, K), weight_v (O, I/g, K), bias (O,)."""

    def __init__(self, dim: int, kernel_size: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel_size))
        self.weight_v = nn.Parameter(
            torch.zeros(dim, dim // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, D, T)
        v = self.weight_v.float()
        norm = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt().clamp_min(1e-12)
        w = (self.weight_g.float() * v / norm).to(x.dtype)
        k = w.shape[-1]
        bias = self.bias.to(x.dtype)
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            # torch's CPU bf16 grouped conv1d returns wrong values for narrow
            # groups (4-8 channels a group, torch 2.13); run it in fp32 on
            # the bf16 operands and round, as an fp32-accumulating bf16 conv
            return F.conv1d(x.float(), w.float(), bias.float(),
                            padding=k // 2, groups=self.groups).to(x.dtype)
        return F.conv1d(x, w, bias, padding=k // 2, groups=self.groups)


class ConvPositionalEmbedding(nn.Module):
    def __init__(self, dim: int, kernel_size: int, groups: int):
        super().__init__()
        self.conv = _WeightNormConv1d(dim, kernel_size, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, D)
        y = self.conv(x.transpose(1, 2))
        if self.conv.weight_v.shape[-1] % 2 == 0:  # SamePad: drop the last
            y = y[:, :, :-1]
        return F.gelu(y.transpose(1, 2))


class EncoderSelfAttention(nn.Module):
    """Wav2vec2-style MHA, scores scaled by d_k**-0.5, biased projections;
    attention-prob dropout at ``dropout`` inside the flash kernels. After
    ``shard_`` it runs its model rank's heads: q/k/v split by columns,
    ``out_proj`` by rows (``core/tensor_parallel.py``), the dropout drawn
    at those heads' place among all of them."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.model_shard = (0, 1)  # (model rank, model size)
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def shard_(self, rank: int, size: int) -> None:
        if self.heads % size:
            raise ValueError(f"{self.heads} heads over {size} model ranks")
        for lin in (self.q_proj, self.k_proj, self.v_proj):
            tp.shard_linear_(lin, 0, rank, size)
        tp.shard_linear_(self.out_proj, 1, rank, size)
        self.model_shard = (rank, size)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        b, t, d = x.shape
        rank, size = self.model_shard
        h, dk = self.heads // size, d // self.heads
        if size > 1:
            x = tp.copy_to_model(x)
        q, k, v = (remat.mark(p(x).view(b, t, h, dk), name)
                   for p, name in ((self.q_proj, "enc_q"),
                                   (self.k_proj, "enc_k"),
                                   (self.v_proj, "enc_v")))
        rate, seed = 0.0, None
        if rng is not None and self.dropout > 0.0:
            rate, seed = self.dropout, rng.flash_seed()
            if size > 1:  # key the draw by the global head
                seed = (*seed, h, self.heads, rank * h)
        out = mha_flash(q, k, v, padding_mask, scale=dk ** -0.5,
                        dropout_rate=rate, dropout_seed=seed)
        return tp.linear(self.out_proj, out.reshape(b, t, h * dk))


class FeedForward(nn.Module):
    def __init__(self, dim: int, units: int, activation_dropout: float = 0.0):
        super().__init__()
        self.activation_dropout = activation_dropout
        self.model_shard = (0, 1)
        self.intermediate_dense = nn.Linear(dim, units)
        self.output_dense = nn.Linear(units, dim)

    def shard_(self, rank: int, size: int) -> None:
        tp.shard_linear_(self.intermediate_dense, 0, rank, size)
        tp.shard_linear_(self.output_dense, 1, rank, size)
        self.model_shard = (rank, size)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        rank, size = self.model_shard
        if size > 1:
            x = tp.copy_to_model(x)
        h = F.gelu(remat.mark(self.intermediate_dense(x), "enc_ffn_pre"))
        h = remat.mark(dropout(h, self.activation_dropout, rng,
                               shard=(-1, rank, size)), "enc_ffn_act")
        return tp.linear(self.output_dense, h)


class EncoderLayer(nn.Module):
    """Pre-LN layer: x + drop(attn(LN(x))), then x + drop(FFN(LN(x)))."""

    def __init__(self, cfg: AVHubertEncoderConfig):
        super().__init__()
        d = cfg.encoder_embed_dim
        self.hidden_dropout = cfg.hidden_dropout
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attention = EncoderSelfAttention(d, cfg.num_attention_heads,
                                              cfg.attention_dropout)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(d, cfg.intermediate_size,
                                        cfg.activation_dropout)

    def forward(self, x, padding_mask, rng: Optional[DropoutRng] = None):
        h = self.attention(self.layer_norm(x), padding_mask, rng)
        x = x + dropout(h, self.hidden_dropout, rng)
        h = self.feed_forward(self.final_layer_norm(x), rng)
        return x + dropout(h, self.hidden_dropout, rng)


class AVHubertTransformer(nn.Module):
    """Conv pos-emb + N pre-LN layers + trailing LayerNorm."""

    def __init__(self, cfg: AVHubertEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder_embed_dim
        self.pos_conv_embed = ConvPositionalEmbedding(
            d, cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.hidden_dropout = cfg.hidden_dropout

    def forward(self, x: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        if padding_mask is not None:
            x = x * padding_mask[..., None].to(x.dtype)
        x = dropout(x + self.pos_conv_embed(x), self.hidden_dropout, rng)
        mode = self.cfg.scan_remat
        for layer in self.layers:
            if mode != "none" and torch.is_grad_enabled():
                x = remat.checkpoint(layer, (x, padding_mask, rng), rng, mode)
            else:
                x = layer(x, padding_mask, rng)
        return self.layer_norm(x)


class _AudioFeatures(nn.Module):
    def __init__(self, feat_dim: int, dim: int):
        super().__init__()
        self.proj = nn.Linear(feat_dim, dim)


class _VideoFeatures(nn.Module):
    def __init__(self, dim: int, relu_type: str = "prelu"):
        super().__init__()
        self.resnet = ResEncoder(relu_type)
        self.proj = nn.Linear(512, dim)


class AVHubertModel(nn.Module):
    """(audio (B,T,104) | None, video (B,T,88,88,1) | None, padding_mask
    (B,T) True = valid | None) -> (B, T, D) features. ``train=True`` needs
    ``rng``: batch-statistics BatchNorm in the frontend, every dropout of
    the config, and the whole-batch modality dropout (one draw per call, so
    the whole batch drops a modality together, as the reference does). On
    the CPU its first call warms torch's exp (``ops/cpu.warm_exp``)."""

    def __init__(self, cfg: AVHubertEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder_embed_dim
        self.feature_extractor_audio = _AudioFeatures(cfg.audio_feat_dim, d)
        self.feature_extractor_video = _VideoFeatures(d, cfg.resnet_relu_type)
        self.layer_norm = nn.LayerNorm(cfg.fused_dim, eps=1e-5)
        if cfg.fused_dim != d:
            self.post_extract_proj = nn.Linear(cfg.fused_dim, d)
        self.encoder = AVHubertTransformer(cfg)

    def forward(self, audio: Optional[torch.Tensor],
                video: Optional[torch.Tensor],
                padding_mask: Optional[torch.Tensor] = None,
                train: bool = False,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        c = self.cfg
        if train and rng is None:
            raise ValueError("train=True needs a DropoutRng")
        if (audio if audio is not None else video).device.type == "cpu":
            warm_exp()  # a caller of the modules themselves (ROADMAP C21)
        rng = rng if train else None
        feats_a = feats_v = None
        if audio is not None:
            feats_a = self.feature_extractor_audio.proj(audio)
        if video is not None:
            fv = self.feature_extractor_video
            if train and c.frontend_remat and torch.is_grad_enabled():
                v = remat.checkpoint(fv.resnet, (video, train))
            else:
                v = fv.resnet(video, train)
            feats_v = fv.proj(v)
        if feats_a is None:
            feats_a = torch.zeros_like(feats_v)
        if feats_v is None:
            feats_v = torch.zeros_like(feats_a)
        if c.modality == "audio":
            feats_v = feats_v * 0
        elif c.modality == "video":
            feats_a = feats_a * 0
        elif train and c.modality_dropout > 0:
            p_mod, p_aud = rng.uniform(2)
            if p_mod < c.modality_dropout:
                if p_aud < c.audio_dropout:
                    feats_a = torch.zeros_like(feats_a)
                else:
                    feats_v = torch.zeros_like(feats_v)
        if c.modality_fuse == "concat":
            feats = torch.cat([feats_a, feats_v], dim=-1)
        else:
            feats = feats_a + feats_v
        feats = self.layer_norm(feats)
        if c.fused_dim != c.encoder_embed_dim:
            feats = self.post_extract_proj(feats)
        feats = dropout(feats, c.dropout_input, rng)
        return self.encoder(feats, padding_mask, rng)
