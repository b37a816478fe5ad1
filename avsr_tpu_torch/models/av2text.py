"""AV2Text (MuAViC): AV-HuBERT encoder + Speech2Text-style decoder.

Counterpart of ``avsr_tpu/models/av2text.py``. The encoder is the port's
``AVHubertModel`` (its self-attention through the flash kernels on the
card). The decoder is the HF Speech2Text pre-LN transformer: fairseq-style
sinusoidal positions offset by ``pad_token_id + 1`` with the padding row
zeroed, embeddings scaled by sqrt(d_model), a LM head tied to the token
embedding, and plain attention with q scaled by d_k**-0.5, masked with the
fp32 minimum and a softmax in fp32. Its LayerNorms take eps 1e-6, the
flax ``nn.LayerNorm()`` default of the JAX decoder (the reference's torch
LayerNorms take 1e-5; ROADMAP C5). Generation steps the decoder over a
fixed-size self-K/V buffer: step ``pos`` writes row ``pos`` and attends to
rows ``<= pos``.

Module and parameter names are the reference checkpoint's without its
``model.`` prefix (``encoder.*``, ``decoder.layers.{i}.self_attn.q_proj``,
...), so a released state dict loads with ``load_state_dict``
(``core/weights.load_state_file(model, path, prefix="model.")``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.core.config import AVHubertEncoderConfig
from avsr_tpu_torch.models.avhubert import AVHubertModel
from avsr_tpu_torch.ops.kernels._build import device_step
from avsr_tpu_torch.ops.masks import make_non_pad_mask

NEG_INF = torch.finfo(torch.float32).min
LN_EPS = 1e-6  # flax nn.LayerNorm's default, the JAX decoder's


@dataclasses.dataclass
class AV2TextConfig:
    vocab_size: int = 10000
    d_model: int = 256
    decoder_layers: int = 6
    decoder_ffn_dim: int = 2048
    decoder_attention_heads: int = 4
    encoder_layers: int = 12
    encoder_ffn_dim: int = 2048
    encoder_attention_heads: int = 4
    max_target_positions: int = 1024
    scale_embedding: bool = True
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    audio_feat_dim: int = 104
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16

    def encoder_config(self) -> AVHubertEncoderConfig:
        return AVHubertEncoderConfig(
            encoder_embed_dim=self.d_model,
            num_hidden_layers=self.encoder_layers,
            num_attention_heads=self.encoder_attention_heads,
            intermediate_size=self.encoder_ffn_dim,
            audio_feat_dim=self.audio_feat_dim,
            num_conv_pos_embeddings=self.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=self.num_conv_pos_embedding_groups,
        )


def s2t_sinusoidal_table(n_pos: int, dim: int,
                         padding_idx: int) -> torch.Tensor:
    """fairseq-style sinusoidal table: [sin | cos] halves, padding row
    zeroed."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32)
                     * -(math.log(10000.0) / (half - 1)))
    args = torch.arange(n_pos, dtype=torch.float32)[:, None] * freq[None, :]
    table = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2:
        table = torch.cat([table, torch.zeros(n_pos, 1)], dim=1)
    table[padding_idx] = 0.0
    return table


class S2TAttention(nn.Module):
    """HF Speech2TextAttention: q scaled by d_k^-0.5, biased projections.
    Inference only (the JAX module's attention dropout is off there)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.view(b, t, self.heads, self.dim // self.heads)

    def project_kv(self, kv: torch.Tensor):
        return self._split(self.k_proj(kv)), self._split(self.v_proj(kv))

    def attend(self, query, k, v, mask):
        """query (N, Tq, D), k and v (N, Tk, H, Dh), mask (N, Tq, Tk) bool
        or None."""
        b, tq, _ = query.shape
        d_k = self.dim // self.heads
        q = self._split(self.q_proj(query) * (d_k ** -0.5))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None], NEG_INF)
        attn = torch.softmax(scores.float(), dim=-1).to(query.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, tq, self.dim)
        return self.out_proj(out)

    def forward(self, query, kv, mask):
        k, v = self.project_kv(kv)
        return self.attend(query, k, v, mask)


class S2TDecoderLayer(nn.Module):
    """Pre-LN Speech2Text decoder layer (self-attn, cross-attn, ReLU FFN)."""

    def __init__(self, cfg: AV2TextConfig):
        super().__init__()
        d, h = cfg.d_model, cfg.decoder_attention_heads
        self.self_attn = S2TAttention(d, h)
        self.encoder_attn = S2TAttention(d, h)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.final_layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.fc1 = nn.Linear(d, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, d)

    def _ffn(self, x):
        return self.fc2(F.relu(self.fc1(x)))

    def forward(self, x, self_mask, memory, memory_mask):
        h = self.self_attn_layer_norm(x)
        x = x + self.self_attn(h, h, self_mask)
        h = self.encoder_attn_layer_norm(x)
        x = x + self.encoder_attn(h, memory, memory_mask)
        return x + self._ffn(self.final_layer_norm(x))

    def step(self, x_t, pos, self_k, self_v, src_k, src_v, memory_mask):
        """x_t (N, 1, D); self_k and self_v (N, maxlen, H, Dh), whose row
        ``pos`` (a (1,) int64 tensor on the device, clamped into the
        buffer as the JAX step's dynamic update is) this writes in place;
        src_k and src_v (N, S, H, Dh)."""
        maxlen = self_k.shape[1]
        h = self.self_attn_layer_norm(x_t)
        k_t, v_t = self.self_attn.project_kv(h)
        row = pos.clamp_max(maxlen - 1)
        self_k.index_copy_(1, row, k_t)
        self_v.index_copy_(1, row, v_t)
        causal = (torch.arange(maxlen, device=x_t.device) <= pos)
        causal = causal[None, None, :].expand(x_t.shape[0], 1, maxlen)
        x = x_t + self.self_attn.attend(h, self_k, self_v, causal)
        h = self.encoder_attn_layer_norm(x)
        x = x + self.encoder_attn.attend(h, src_k, src_v, memory_mask)
        return x + self._ffn(self.final_layer_norm(x))


class S2TDecoderCache(NamedTuple):
    self_k: torch.Tensor  # (L, N, maxlen, H, Dh)
    self_v: torch.Tensor
    src_k: torch.Tensor  # (L, N, S, H, Dh)
    src_v: torch.Tensor


class S2TDecoder(nn.Module):
    """Speech2Text decoder with a tied-embedding LM head and K/V-cache
    steps."""

    def __init__(self, cfg: AV2TextConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.layers = nn.ModuleList(
            S2TDecoderLayer(cfg) for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.embed_scale = (math.sqrt(cfg.d_model) if cfg.scale_embedding
                            else 1.0)
        # fairseq offset: the first non-pad position is padding_idx + 1
        self.register_buffer("pos_table", s2t_sinusoidal_table(
            cfg.max_target_positions + cfg.pad_token_id + 1, cfg.d_model,
            cfg.pad_token_id), persistent=False)

    def _logits(self, x):
        # lm_head tied to embed_tokens (avhubert2text.py:17-18)
        return x @ self.embed_tokens.weight.T

    def forward(self, ys, memory, memory_mask=None):
        """Teacher-forced: ys (B, L) -> logits (B, L, V). Positions are
        contiguous from the first (generation-style ids, no pad handling)."""
        b, l = ys.shape
        pos_ids = (torch.arange(l, device=ys.device)
                   + self.cfg.pad_token_id + 1)
        x = (self.embed_tokens(ys) * self.embed_scale
             + self.pos_table[pos_ids][None])
        causal = torch.ones(l, l, dtype=torch.bool, device=ys.device).tril()
        causal = causal[None].expand(b, l, l)
        for layer in self.layers:
            x = layer(x, causal, memory, memory_mask)
        return self._logits(self.layer_norm(x))

    def init_cache(self, memory, maxlen: int) -> S2TDecoderCache:
        c = self.cfg
        n = memory.shape[0]
        h = c.decoder_attention_heads
        dh = c.d_model // h
        src = [layer.encoder_attn.project_kv(memory) for layer in self.layers]
        shape = (c.decoder_layers, n, maxlen, h, dh)
        return S2TDecoderCache(
            memory.new_zeros(shape), memory.new_zeros(shape),
            torch.stack([k for k, _ in src]), torch.stack([v for _, v in src]))

    def step(self, y_t, pos, cache: S2TDecoderCache, memory_mask=None):
        """One token a lane: y_t (N,) -> (log-probs (N, V) fp32, cache).
        ``pos``: the step, a one-element int tensor on the device (the
        beam's device loop) or an int; every use of it stays on the
        device."""
        c = self.cfg
        pos = device_step(pos, y_t.device).long()  # (1,)
        x = self.embed_tokens(y_t)[:, None, :] * self.embed_scale
        # the JAX step's dynamic slice clamps the row into the table
        row = (pos + c.pad_token_id + 1).clamp_max(
            self.pos_table.shape[0] - 1)
        x = x + self.pos_table.index_select(0, row)
        for i, layer in enumerate(self.layers):
            x = layer.step(x, pos, cache.self_k[i], cache.self_v[i],
                           cache.src_k[i], cache.src_v[i], memory_mask)
        logits = self._logits(self.layer_norm(x[:, 0]))
        return torch.log_softmax(logits.float(), dim=-1), cache


class AV2TextModel(nn.Module):
    """The MuAViC model: encode, teacher-forced logits and generation
    steps."""

    def __init__(self, cfg: AV2TextConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = AVHubertModel(cfg.encoder_config())
        self.decoder = S2TDecoder(cfg)

    def encode(self, audio, video, lengths=None):
        t = (video if video is not None else audio).shape[1]
        mask = make_non_pad_mask(lengths, t) if lengths is not None else None
        return self.encoder(audio, video, mask)

    def decoder_init(self, memory, maxlen: int) -> S2TDecoderCache:
        return self.decoder.init_cache(memory, maxlen)

    def decoder_step(self, y_t, pos, cache, memory_mask=None):
        return self.decoder.step(y_t, pos, cache, memory_mask)

    def forward(self, audios, videos, decoder_input_ids, lengths=None):
        """Teacher-forced logits (B, L, V), the HF forward's."""
        memory = self.encode(audios, videos, lengths)
        mem_mask = None
        if lengths is not None:
            mem_mask = make_non_pad_mask(lengths, memory.shape[1])[:, None, :]
        return self.decoder(decoder_input_ids, memory, mem_mask)
