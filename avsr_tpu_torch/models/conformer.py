"""Conformer encoders and the auto_avsr / auto_asr / auto_vsr models.

Counterpart of ``avsr_tpu/models/conformer.py`` (the reference's conformer
stack: encoder.py, encoder_layer.py, the rel-pos attention and embedding,
the Conv3D and raw-waveform ResNet frontends, nets_utils.MLPHead and the
E2E graphs e2e_asr_conformer_av.py / e2e_asr_conformer.py), with the same
names, defaults and semantics:

- ``ConformerLayer``: macaron FFN x0.5, rel-pos MHA, the conv module
  (pointwise conv + GLU, depthwise conv, BatchNorm, swish, pointwise conv),
  FFN x0.5 and a final LayerNorm; every LayerNorm eps 1e-12.
- ``Conv3dResNetFrontend``: Conv3d stem + BN + swish + 3x3/s2 max-pool per
  frame, then the swish ResNet-18 trunk (``models/resnet.py``).
- ``Conv1dResNetFrontend``: the raw 16 kHz waveform (trimmed to a multiple
  of 640 samples) through a ResNet-1D to 512 channels at 25 Hz.
- ``ConformerAVSR``: a video and an audio encoder fused by an MLP head
  (Linear, BatchNorm, ReLU, Linear), a CTC head and the shared
  ``TransformerDecoder``; ``ConformerASR``: one encoder.

Module names follow the reference checkpoint (``encoders.{i}``,
``conv_module.pointwise_cov1`` as the reference spells it,
``frontend.frontend3D.0``, ``frontend.trunk.*``, ``fusion.fc1``,
``ctc.ctc_lo``), so a released state dict loads with
``load_state_dict(strict=True)``. Tensors are (B, T, C) between modules;
convolutions and BatchNorms run channels-first, as torch has them. The
JAX package's ``GroupedConv`` (a GSPMD workaround) and folded Conv3d stem
(a TPU layout workaround) are plain ``groups=`` and ``nn.Conv3d`` here, and
its ``decode_fused_attention`` switch has no counterpart: the decoder
always takes the port's decode kernels (``decode_fused_layer`` selects
the one-launch layer, as in JAX).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.models.decoder import (LN_EPS, NEG_INF, DecoderCache,
                                           TransformerDecoder)
from avsr_tpu_torch.models.e2e import _CTCHead
from avsr_tpu_torch.models.resnet import BatchNorm, ResNetTrunk
from avsr_tpu_torch.ops.ctc import ctc_loss, label_smoothing_loss, th_accuracy
from avsr_tpu_torch.ops.dropout import DropoutRng, dropout
from avsr_tpu_torch.ops.masks import (add_sos_eos, make_non_pad_mask,
                                      target_mask)

WAVE_FRAME = 640  # waveform samples a video frame (16 kHz over 25 fps)


def rel_positional_encoding(t: int, d_model: int, device=None,
                            dtype=torch.float32) -> torch.Tensor:
    """(1, 2T-1, d) relative position table, positions T-1 .. -(T-1)."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / d_model))
    pe_pos = torch.zeros(t, d_model, device=device)
    pe_pos[:, 0::2] = torch.sin(pos * div)
    pe_pos[:, 1::2] = torch.cos(pos * div)
    pe_neg = torch.zeros(t, d_model, device=device)
    pe_neg[:, 0::2] = torch.sin(-pos * div)
    pe_neg[:, 1::2] = torch.cos(-pos * div)
    pe = torch.cat([torch.flip(pe_pos, [0]), pe_neg[1:]])
    return pe[None].to(dtype)


class RelPositionAttention(nn.Module):
    """Transformer-XL rel-pos MHA (the reference's RelPositionMultiHeaded
    attention, 'latest' rel_shift): scores (q + u) k + rel_shift((q + v) p)
    over sqrt(d_k), masked keys filled with the fp32 minimum before an fp32
    softmax and zeroed after it."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.linear_q = nn.Linear(dim, dim)
        self.linear_k = nn.Linear(dim, dim)
        self.linear_v = nn.Linear(dim, dim)
        self.linear_out = nn.Linear(dim, dim)
        self.linear_pos = nn.Linear(dim, dim, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, dim // heads))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, dim // heads))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """x (B, T, C), pos_emb (1, 2T-1, C), mask (B, 1, T) True = valid."""
        b, t, c = x.shape
        h, dk = self.heads, c // self.heads
        q = self.linear_q(x).view(b, t, h, dk)
        k = self.linear_k(x).view(b, t, h, dk)
        v = self.linear_v(x).view(b, t, h, dk)
        p = self.linear_pos(pos_emb).view(-1, h, dk)  # (2T-1, H, Dk)
        ac = torch.einsum("bqhd,bkhd->bhqk", q + self.pos_bias_u, k)
        bd = torch.einsum("bqhd,khd->bhqk", q + self.pos_bias_v, p)
        # rel_shift: (B,H,T,2T-1) -> (B,H,T,T), keeping positions 0..T-1
        padded = torch.cat([bd.new_zeros(b, h, t, 1), bd], dim=-1)
        padded = padded.view(b, h, 2 * t, t)
        bd = padded[:, :, 1:].reshape(b, h, t, 2 * t - 1)[..., :t]
        scores = (ac + bd) / math.sqrt(dk)
        if mask is not None:
            m = mask[:, None]  # (B, 1, 1, T)
            scores = scores.float().masked_fill(~m, NEG_INF)
            attn = torch.softmax(scores, dim=-1).to(x.dtype)
            attn = attn.masked_fill(~m, 0.0)
        else:
            attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        attn = dropout(attn, self.dropout, rng)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, c)
        return self.linear_out(out)


class ConvolutionModule(nn.Module):
    """Conformer conv module (the reference's convolution.py): pointwise
    conv to 2C and GLU, depthwise conv (k=31, padding 15), BatchNorm,
    swish, pointwise conv."""

    def __init__(self, dim: int, kernel: int = 31):
        super().__init__()
        self.pointwise_cov1 = nn.Conv1d(dim, 2 * dim, 1)
        self.depthwise_conv = nn.Conv1d(dim, dim, kernel,
                                        padding=kernel // 2, groups=dim)
        self.norm = BatchNorm(dim)
        self.pointwise_cov2 = nn.Conv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.glu(self.pointwise_cov1(x.transpose(1, 2)), dim=1)
        h = F.silu(self.norm(self.depthwise_conv(h), train))
        return self.pointwise_cov2(h).transpose(1, 2)


class FeedForward(nn.Module):
    def __init__(self, dim: int, units: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.w_1 = nn.Linear(dim, units)
        self.w_2 = nn.Linear(units, dim)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.w_2(dropout(F.relu(self.w_1(x)), self.dropout, rng))


class ConformerLayer(nn.Module):
    """Macaron FFN + rel-MHA + conv module + FFN + final LN (the
    reference's encoder_layer.py, macaron and cnn on); dropout before each
    residual."""

    def __init__(self, dim: int, heads: int, units: int, dropout: float,
                 attn_dropout: float, cnn_kernel: int = 31,
                 macaron: bool = True, use_cnn: bool = True):
        super().__init__()
        self.dropout = dropout
        self.macaron = macaron
        if macaron:
            self.norm_ff_macaron = nn.LayerNorm(dim, eps=LN_EPS)
            self.feed_forward_macaron = FeedForward(dim, units, dropout)
        self.norm_mha = nn.LayerNorm(dim, eps=LN_EPS)
        self.self_attn = RelPositionAttention(dim, heads, attn_dropout)
        self.use_cnn = use_cnn
        if use_cnn:
            self.norm_conv = nn.LayerNorm(dim, eps=LN_EPS)
            self.conv_module = ConvolutionModule(dim, cnn_kernel)
            self.norm_final = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_ff = nn.LayerNorm(dim, eps=LN_EPS)
        self.feed_forward = FeedForward(dim, units, dropout)

    def forward(self, x, pos_emb, mask, train: bool = False,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        def drop(h):
            return dropout(h, self.dropout, rng)

        if self.macaron:
            h = self.feed_forward_macaron(self.norm_ff_macaron(x), rng)
            x = x + 0.5 * drop(h)
        x = x + drop(self.self_attn(self.norm_mha(x), pos_emb, mask, rng))
        if self.use_cnn:
            x = x + drop(self.conv_module(self.norm_conv(x), train))
        h = self.feed_forward(self.norm_ff(x), rng)
        x = x + (0.5 if self.macaron else 1.0) * drop(h)
        return self.norm_final(x) if self.use_cnn else x


class Conv3dResNetFrontend(nn.Module):
    """Video frontend (the reference's conv3d_extractor.py): (B, T, H, W, 1)
    frames -> (B, T, 512). ``frontend3D``: Conv3d(1->64, k=(5,7,7),
    s=(1,2,2), p=(2,3,3), no bias), BN, swish (PReLU for any other
    ``relu_type``, as in the JAX package), then a 3x3/s2/p1 max-pool per
    frame and the ResNet-18 trunk."""

    def __init__(self, relu_type: str = "swish"):
        super().__init__()
        self.frontend3D = nn.ModuleList([
            nn.Conv3d(1, 64, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3),
                      bias=False),
            BatchNorm(64),
            nn.SiLU() if relu_type == "swish" else nn.PReLU(64),
        ])
        self.trunk = ResNetTrunk(relu_type=relu_type)

    def forward(self, video: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        b, t = video.shape[:2]
        conv, bn, act = self.frontend3D
        x = conv(video.permute(0, 4, 1, 2, 3))  # (B, 64, T, H/2, W/2)
        c, h, w = x.shape[1], x.shape[3], x.shape[4]
        # fold time into batch (pure relayout: pooling never mixes frames)
        x = x.transpose(1, 2).reshape(b * t, c, h, w)
        x = F.max_pool2d(act(bn(x, train)), 3, stride=2, padding=1)
        return self.trunk(x, train).view(b, t, -1)


class BasicBlock1D(nn.Module):
    """ResNet-1D basic block: k=3 convs, stride in conv1, 1x1-conv
    downsample, swish (ReLU for any other ``relu_type``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, relu_type: str = "swish"):
        super().__init__()
        self.act = F.silu if relu_type == "swish" else F.relu
        self.conv1 = nn.Conv1d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv1d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = (
            nn.Sequential(nn.Conv1d(inplanes, planes, 1, stride=stride,
                                    bias=False), BatchNorm(planes))
            if downsample else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.act(self.bn1(self.conv1(x), train))
        h = self.bn2(self.conv2(h), train)
        res = x
        if self.downsample is not None:
            conv, bn = self.downsample
            res = bn(conv(x), train)
        return self.act(h + res)


class ResNet1D(nn.Module):
    """conv1 (k=80, stride 4, padding 38), BN, swish, then four stages of
    two ``BasicBlock1D`` (64, 128, 256, 512 channels; stride 2 from the
    second), each stage's first block downsampling where the stride or the
    width changes."""

    def __init__(self, relu_type: str = "swish"):
        super().__init__()
        self.conv1 = nn.Conv1d(1, 64, 80, stride=4, padding=38, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if stage == 0 else 2
            blocks = []
            for blk in range(2):
                s = stride if blk == 0 else 1
                blocks.append(BasicBlock1D(
                    inplanes, planes, s,
                    downsample=blk == 0 and (s != 1 or inplanes != planes),
                    relu_type=relu_type))
                inplanes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.silu(self.bn1(self.conv1(x), train))
        for stage in range(1, 5):
            for block in getattr(self, f"layer{stage}"):
                x = block(x, train)
        return x


class Conv1dResNetFrontend(nn.Module):
    """Audio frontend (the reference's conv1d_extractor.py): the raw wave
    (B, T, 1), trimmed to a multiple of 640 samples, -> (B, T/640, 512):
    ``ResNet1D`` (160 samples a step after conv1 and 20 after the stages)
    and an average pool of 20 steps that drops a remainder."""

    def __init__(self, relu_type: str = "swish"):
        super().__init__()
        self.trunk = ResNet1D(relu_type)

    def forward(self, wave: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        b, t, _ = wave.shape
        x = self.trunk(wave[:, : t // WAVE_FRAME * WAVE_FRAME].transpose(1, 2),
                       train)
        t_out = x.shape[2] // 20
        x = x[:, :, : t_out * 20].reshape(b, x.shape[1], t_out, 20).mean(-1)
        return x.transpose(1, 2)


class ConformerEncoder(nn.Module):
    """Frontend + Linear(512 -> dim) x sqrt(dim) + rel-pos table + N
    conformer layers + LN. ``input_layer``: ``"conv3d"`` (video frames
    (B, T, 88, 88, 1)), ``"conv1d"`` (waveform (B, T, 1)) or ``"none"``
    (features (B, T, 512))."""

    def __init__(self, dim: int = 768, heads: int = 12, units: int = 3072,
                 layers: int = 12, dropout: float = 0.1,
                 attn_dropout: float = 0.1, cnn_kernel: int = 31,
                 input_layer: str = "conv3d", relu_type: str = "swish"):
        super().__init__()
        self.dim = dim
        self.dropout = dropout
        frontends = {"conv3d": Conv3dResNetFrontend,
                     "conv1d": Conv1dResNetFrontend}
        if input_layer in frontends:
            self.frontend = frontends[input_layer](relu_type)
        elif input_layer != "none":
            raise ValueError(f"unknown input_layer {input_layer!r}")
        self.embed = nn.Sequential(nn.Linear(512, dim))
        self.encoders = nn.ModuleList(
            ConformerLayer(dim, heads, units, dropout, attn_dropout,
                           cnn_kernel) for _ in range(layers))
        self.after_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, xs: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """mask: (B, 1, T_out) True = valid, or None. Returns
        (B, T_out, dim)."""
        if hasattr(self, "frontend"):
            xs = self.frontend(xs, train)
        x = self.embed(xs) * math.sqrt(self.dim)
        pos_emb = rel_positional_encoding(x.shape[1], self.dim, x.device,
                                          x.dtype)
        x = dropout(x, self.dropout, rng)
        pos_emb = dropout(pos_emb, self.dropout, rng)
        for layer in self.encoders:
            x = layer(x, pos_emb, mask, train, rng)
        return self.after_norm(x)


class MLPHead(nn.Module):
    """AV fusion head: Linear -> BatchNorm over the channels -> ReLU ->
    Linear (the reference's nets_utils.MLPHead)."""

    def __init__(self, idim: int, hdim: int, odim: int):
        super().__init__()
        self.fc1 = nn.Linear(idim, hdim)
        self.bn1 = BatchNorm(hdim)
        self.fc2 = nn.Linear(hdim, odim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.fc1(x)
        h = self.bn1(h.reshape(-1, h.shape[-1]), train).view(h.shape)
        return self.fc2(F.relu(h))


class ConformerOutput(NamedTuple):
    loss: torch.Tensor
    loss_ctc: torch.Tensor
    loss_att: torch.Tensor
    acc: torch.Tensor


class _ConformerE2E(nn.Module):
    """What the two conformer models share: the CTC head, the decoder, the
    token ids (sos = eos = odim - 1, blank 0) the Recognizer reads from its
    ``cfg``, the decode methods and the joint loss."""

    def __init__(self, odim: int, dim: int, ddim: int, dheads: int,
                 dunits: int, dlayers: int, dropout: float,
                 attn_dropout: float, lsm_weight: float, mtlalpha: float,
                 decode_fused_layer: bool):
        super().__init__()
        self.odim = odim
        self.dropout = dropout
        self.lsm_weight = lsm_weight
        self.mtlalpha = mtlalpha
        self.ctc = _CTCHead(dim, odim)
        self.decoder = TransformerDecoder(
            odim=odim, dim=ddim, heads=dheads, units=dunits, layers=dlayers,
            dropout=dropout, attn_dropout=attn_dropout,
            fused_layer=decode_fused_layer)

    @property
    def sos(self) -> int:
        return self.odim - 1

    eos = sos

    @property
    def blank(self) -> int:
        return 0

    def ctc_log_probs(self, feats: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.ctc.ctc_lo(feats).float(), dim=-1)

    def ctc_logits(self, feats: torch.Tensor,
                   rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.ctc.ctc_lo(dropout(feats, self.dropout, rng))

    def decoder_init(self, memory: torch.Tensor, maxlen: int,
                     beam: int = 1) -> DecoderCache:
        return self.decoder.init_cache(memory, maxlen, beam)

    def decoder_step(self, y_t, pos: int, cache: DecoderCache,
                     memory_mask=None, lane_bias=None):
        return self.decoder.step(y_t, pos, cache, memory_mask, lane_bias)

    def _losses(self, x, out_lens, labels, label_lengths,
                rng: Optional[DropoutRng]) -> ConformerOutput:
        loss_ctc = ctc_loss(self.ctc_logits(x, rng), out_lens, labels,
                            label_lengths)
        ys_in, ys_out = add_sos_eos(labels, label_lengths, self.sos, self.sos)
        pad_mask = make_non_pad_mask(out_lens, x.shape[1])
        pred = self.decoder(ys_in, target_mask(ys_in), x,
                            pad_mask[:, None, :], rng)
        loss_att = label_smoothing_loss(pred, ys_out, self.lsm_weight)
        loss = self.mtlalpha * loss_ctc + (1 - self.mtlalpha) * loss_att
        return ConformerOutput(loss, loss_ctc, loss_att,
                               th_accuracy(pred, ys_out))


class ConformerAVSR(_ConformerE2E):
    """auto_avsr E2E (the reference's e2e_asr_conformer_av.py): a conv3d
    video encoder (``encoder``) and a conv1d audio encoder
    (``aux_encoder``), concatenated and fused by ``MLPHead``, a CTC head
    and the transformer decoder."""

    def __init__(self, odim: int = 5049, adim: int = 768, aheads: int = 12,
                 eunits: int = 3072, elayers: int = 12, ddim: int = 768,
                 dheads: int = 12, dunits: int = 3072, dlayers: int = 6,
                 fusion_hdim: int = 8192, dropout: float = 0.1,
                 attn_dropout: float = 0.1, cnn_kernel: int = 31,
                 lsm_weight: float = 0.1, mtlalpha: float = 0.1,
                 decode_fused_layer: bool = False):
        super().__init__(odim, adim, ddim, dheads, dunits, dlayers, dropout,
                         attn_dropout, lsm_weight, mtlalpha,
                         decode_fused_layer)
        self.elayers, self.dlayers = elayers, dlayers
        self.encoder, self.aux_encoder = (
            ConformerEncoder(adim, aheads, eunits, elayers, dropout,
                             attn_dropout, cnn_kernel, input_layer=layer)
            for layer in ("conv3d", "conv1d"))
        self.fusion = MLPHead(2 * adim, fusion_hdim, adim)

    def encode(self, audios: torch.Tensor, videos: torch.Tensor,
               lengths: Optional[torch.Tensor] = None, train: bool = False,
               rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """audios: raw waveform (B, T*640, 1); videos (B, T, 88, 88, 1);
        lengths: video frames (B,). Both encoders take the video frames'
        mask. The argument order (audio, video) is the AV-HuBERT model's,
        so the Recognizer drives either."""
        vmask = None
        if lengths is not None:
            vmask = make_non_pad_mask(lengths, videos.shape[1])[:, None, :]
        video_feat = self.encoder(videos, vmask, train, rng)
        audio_feat = self.aux_encoder(audios, vmask, train, rng)
        return self.fusion(torch.cat([video_feat, audio_feat], dim=-1), train)

    def forward(self, videos: torch.Tensor, audios: torch.Tensor,
                labels: torch.Tensor, video_lengths: torch.Tensor,
                label_lengths: torch.Tensor, train: bool = False,
                rng: Optional[DropoutRng] = None) -> ConformerOutput:
        """The joint loss mtlalpha * CTC + (1 - mtlalpha) * label-smoothed
        CE and the token accuracy; labels (B, L) padded with -1.
        ``train=True`` turns on the dropouts (with ``rng``) and the
        BatchNorms' batch statistics."""
        rng = rng if train else None
        x = self.encode(audios, videos, video_lengths, train, rng)
        return self._losses(x, video_lengths, labels, label_lengths, rng)


class ConformerASR(_ConformerE2E):
    """auto_asr (``input_layer="conv1d"``, the waveform) or auto_vsr
    (``"conv3d"``, video frames) single-modality E2E (the reference's
    e2e_asr_conformer.py)."""

    def __init__(self, odim: int = 5049, adim: int = 768, aheads: int = 12,
                 eunits: int = 3072, elayers: int = 12, ddim: int = 768,
                 dheads: int = 12, dunits: int = 3072, dlayers: int = 6,
                 dropout: float = 0.1, attn_dropout: float = 0.1,
                 cnn_kernel: int = 31, lsm_weight: float = 0.1,
                 mtlalpha: float = 0.1, decode_fused_layer: bool = False,
                 input_layer: str = "conv1d"):
        super().__init__(odim, adim, ddim, dheads, dunits, dlayers, dropout,
                         attn_dropout, lsm_weight, mtlalpha,
                         decode_fused_layer)
        self.elayers, self.dlayers = elayers, dlayers
        self.input_layer = input_layer
        self.encoder = ConformerEncoder(adim, aheads, eunits, elayers,
                                        dropout, attn_dropout, cnn_kernel,
                                        input_layer=input_layer)

    def _out_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return lengths // WAVE_FRAME if self.input_layer == "conv1d" \
            else lengths

    def encode(self, xs: torch.Tensor,
               lengths: Optional[torch.Tensor] = None, train: bool = False,
               rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """xs: waveform (B, T, 1) or video (B, T, 88, 88, 1); lengths in
        samples or frames (B,)."""
        mask = None
        if lengths is not None:
            out_len = (xs.shape[1] // WAVE_FRAME
                       if self.input_layer == "conv1d" else xs.shape[1])
            mask = make_non_pad_mask(self._out_lengths(lengths),
                                     out_len)[:, None, :]
        return self.encoder(xs, mask, train, rng)

    def forward(self, xs: torch.Tensor, labels: torch.Tensor,
                lengths: torch.Tensor, label_lengths: torch.Tensor,
                train: bool = False,
                rng: Optional[DropoutRng] = None) -> ConformerOutput:
        rng = rng if train else None
        x = self.encode(xs, lengths, train, rng)
        return self._losses(x, self._out_lengths(lengths), labels,
                            label_lengths, rng)
