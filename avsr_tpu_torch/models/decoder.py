"""Transformer decoder (ESPnet lineage): teacher-forced forward and the
incremental decode path.

Counterpart of ``avsr_tpu/models/decoder.py``. ``forward`` is the training
path (reference decoder.py:39): embedding x sqrt(d) + sinusoidal positions,
dropout, N pre-LN layers (self-attention, source attention, ReLU FFN; LN
eps 1e-12), after_norm and the output layer; masked attention weights are
set back to 0 after the softmax. ``init_cache``/``step`` are the serving
path: the fused decode path (``decode_fused_attention``) with lazy beam
reorder and shared source K/V.

Per step and layer: LN -> one concatenated QKV product -> q * d_k**-0.5 ->
``decode_attention`` (which writes the step's K|V row into the cache) ->
linear_out; LN -> cross-attention with the beam lanes folded into the query
axis; LN -> ReLU FFN. With ``fused_layer`` (the config's
``decode_fused_layer``) each layer is instead one ``decoder_layer_step``
launch with the TPU kernel's semantics (``ops/kernels/decoder_layer.py``).
Then after_norm (fp32), the output head in the decoder parameter dtype, and
an fp32 log-softmax. Module names follow the reference checkpoint
(``embed.0``, ``decoders.{i}.self_attn.linear_q``...).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from avsr_tpu_torch.core import tensor_parallel as tp
from avsr_tpu_torch.ops.dropout import DropoutRng, dropout
from avsr_tpu_torch.ops.kernels._build import device_step
from avsr_tpu_torch.ops.kernels.decode_attention import decode_attention
from avsr_tpu_torch.ops.kernels.decoder_layer import NEG_INF as PAD_BIAS
from avsr_tpu_torch.ops.kernels.decoder_layer import (
    PackedLayer,
    Scratch,
    decoder_layer_step,
    layer_scratch,
    pack_layer_params,
)

LN_EPS = 1e-12
NEG_INF = torch.finfo(torch.float32).min


def sinusoidal_pe(maxlen: int, d_model: int, device=None) -> torch.Tensor:
    """(maxlen, d) fp32 sin/cos table (reference embedding.py:55)."""
    position = torch.arange(maxlen, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / d_model)
    )
    pe = torch.zeros(maxlen, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class MultiHeadAttention(nn.Module):
    """ESPnet MHA: scores / sqrt(d_k), biased projections, masked weights
    zeroed after the softmax, attention dropout. After ``shard_`` (the
    training forward only) it runs its model rank's heads:
    ``linear_q/k/v`` split by columns, ``linear_out`` by rows
    (``core/tensor_parallel.py``)."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.model_shard = (0, 1)  # (model rank, model size)
        self.linear_q = nn.Linear(dim, dim)
        self.linear_k = nn.Linear(dim, dim)
        self.linear_v = nn.Linear(dim, dim)
        self.linear_out = nn.Linear(dim, dim)

    def shard_(self, rank: int, size: int) -> None:
        if self.heads % size:
            raise ValueError(f"{self.heads} heads over {size} model ranks")
        for lin in (self.linear_q, self.linear_k, self.linear_v):
            tp.shard_linear_(lin, 0, rank, size)
        tp.shard_linear_(self.linear_out, 1, rank, size)
        self.model_shard = (rank, size)

    def forward(self, query, key, value, mask: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """query (B, Tq, D), key/value (B, Tk, D), mask (B, Tq | 1, Tk)
        True = keep."""
        b, tq, d = query.shape
        rank, size = self.model_shard
        h, dk = self.heads // size, d // self.heads
        if size > 1:  # one copy for each distinct input
            copies = {}
            for x in (query, key, value):
                if id(x) not in copies:
                    copies[id(x)] = tp.copy_to_model(x)
            query, key, value = (copies[id(x)] for x in (query, key, value))

        def split(x):  # (B, T, h * Dh) -> (B, h, T, Dh)
            return x.view(b, -1, h, dk).transpose(1, 2)

        q = split(self.linear_q(query))
        k = split(self.linear_k(key))
        v = split(self.linear_v(value))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
        if mask is not None:
            m = mask[:, None]  # (B, 1, Tq | 1, Tk)
            scores = scores.float().masked_fill(~m, NEG_INF)
            attn = torch.softmax(scores, dim=-1).to(query.dtype)
            attn = attn.masked_fill(~m, 0.0)
        else:
            attn = torch.softmax(scores.float(), dim=-1).to(query.dtype)
        attn = dropout(attn, self.dropout, rng, shard=(1, rank, size))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, tq, h * dk)
        return tp.linear(self.linear_out, out)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, units: int):
        super().__init__()
        self.w_1 = nn.Linear(dim, units)
        self.w_2 = nn.Linear(units, dim)


class DecoderLayer(nn.Module):
    """Pre-LN block (reference decoder_layer.py:16): self-attention, source
    attention and a ReLU FFN, each with dropout before its residual. After
    ``shard_`` the FFN runs its model rank's columns (``w_1`` split by
    columns, ``w_2`` by rows)."""

    def __init__(self, dim: int, heads: int, units: int, dropout: float = 0.0,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.model_shard = (0, 1)
        self.self_attn = MultiHeadAttention(dim, heads, attn_dropout)
        self.src_attn = MultiHeadAttention(dim, heads, attn_dropout)
        self.feed_forward = _FeedForward(dim, units)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def shard_(self, rank: int, size: int) -> None:
        tp.shard_linear_(self.feed_forward.w_1, 0, rank, size)
        tp.shard_linear_(self.feed_forward.w_2, 1, rank, size)
        self.model_shard = (rank, size)

    def forward(self, x, tgt_mask, memory, memory_mask,
                rng: Optional[DropoutRng] = None):
        h = self.norm1(x)
        x = x + dropout(self.self_attn(h, h, h, tgt_mask, rng), self.dropout,
                        rng)
        h = self.norm2(x)
        x = x + dropout(self.src_attn(h, memory, memory, memory_mask, rng),
                        self.dropout, rng)
        ff = self.feed_forward
        rank, size = self.model_shard
        h = self.norm3(x)
        if size > 1:
            h = tp.copy_to_model(h)
        h = dropout(F.relu(ff.w_1(h)), self.dropout, rng,
                    shard=(-1, rank, size))
        return x + dropout(tp.linear(ff.w_2, h), self.dropout, rng)


@dataclass
class LayerParams:
    """One layer's decode-step weights, cast once to the parameter dtype."""

    norm1: tuple
    w_qkv: torch.Tensor  # (3C, C): linear_q | linear_k | linear_v
    b_qkv: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor
    norm2: tuple
    w_q_src: torch.Tensor
    b_q_src: torch.Tensor
    w_out_src: torch.Tensor
    b_out_src: torch.Tensor
    norm3: tuple
    w_1: torch.Tensor
    b_1: torch.Tensor
    w_2: torch.Tensor
    b_2: torch.Tensor


@dataclass
class DecoderCache:
    """Decode state over B*K lanes.

    self_kv: per layer one (B*K, S, 2C) K|V buffer in the cache dtype,
    updated in place by each step; src_k / src_v: per layer the source K/V
    shared by the K lanes of an utterance, (B, H, S_enc, Dh) in the cache
    dtype, or (B, S_enc, C) with the heads packed on the fused-layer path;
    params: per-layer weights in the parameter dtype (``PackedLayer`` on
    the fused-layer path); head_w (V, C) in the parameter dtype; pe: the
    positional table (fp32). The fused-layer path also keeps the kernel's
    fp32 scratch, made at init, and the additive source-padding bias
    (B, S_enc), made at the first step from its memory_mask (the mask it
    came from kept beside it)."""

    self_kv: List[torch.Tensor]
    src_k: List[torch.Tensor]
    src_v: List[torch.Tensor]
    params: List[LayerParams | PackedLayer]
    head_w: torch.Tensor
    pe: torch.Tensor
    scratch: Optional[Scratch] = None
    mem_bias: Optional[torch.Tensor] = None
    mem_mask: Optional[torch.Tensor] = None


def _ln(x, p):
    return F.layer_norm(x, x.shape[-1:], p[0], p[1], LN_EPS)


class TransformerDecoder(nn.Module):
    def __init__(self, odim: int, dim: int = 1024, heads: int = 16,
                 units: int = 3072, layers: int = 6, dropout: float = 0.0,
                 attn_dropout: float = 0.0, max_decode_len: int = 512,
                 cache_dtype: str = "float32", param_dtype: str = "float32",
                 fused_layer: bool = False):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.dropout = dropout
        self.fused_layer = fused_layer
        self.max_decode_len = max_decode_len
        self.cache_dtype = getattr(torch, cache_dtype)
        self.param_dtype = getattr(torch, param_dtype)
        self.embed = nn.Sequential(nn.Embedding(odim, dim))
        self.decoders = nn.ModuleList(
            DecoderLayer(dim, heads, units, dropout, attn_dropout)
            for _ in range(layers))
        self.after_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.output_layer = nn.Linear(dim, odim)

    def forward(self, ys_in: torch.Tensor, ys_mask: Optional[torch.Tensor],
                memory: torch.Tensor, memory_mask: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        """Teacher-forced logits (B, L, V) for ys_in (B, L), its mask
        (B, L, L), memory (B, S, D) and memory_mask (B, 1, S); ``rng``
        turns on the dropouts (training)."""
        x = self.embed[0](ys_in) * math.sqrt(self.dim)
        pe = sinusoidal_pe(ys_in.shape[-1], self.dim, ys_in.device)
        x = dropout(x + pe.to(x.dtype), self.dropout, rng)
        for layer in self.decoders:
            x = layer(x, ys_mask, memory, memory_mask, rng)
        return self.output_layer(self.after_norm(x))

    @torch.no_grad()
    def init_cache(self, memory: torch.Tensor, maxlen: int,
                   beam: int = 1) -> DecoderCache:
        """Source K/V from per-utterance memory (B, S_enc, D), zeroed
        (B*beam, maxlen, 2C) self K|V buffers, weights cast (or, on the
        fused-layer path, packed) once."""
        if self.decoders[0].model_shard[1] > 1:
            raise ValueError("the decode step runs an unsharded decoder: "
                             "load tensor_parallel.full_state_dict of a "
                             "sharded model into an unsharded one")
        b, s_enc, _ = memory.shape
        h, dh = self.heads, self.dim // self.heads
        pd, cd = self.param_dtype, self.cache_dtype

        def cast(*ts):
            return tuple(t.to(pd) for t in ts)

        def split(x):  # (B, S, C) -> (B, H, S, Dh)
            if self.fused_layer:  # the kernel reads the heads packed
                return x.contiguous()
            return x.view(b, s_enc, h, dh).transpose(1, 2).contiguous()

        self_kv, src_k, src_v, params = [], [], [], []
        for layer in self.decoders:
            sa, xa, ff = layer.self_attn, layer.src_attn, layer.feed_forward
            src_k.append(split(xa.linear_k(memory)).to(cd))
            src_v.append(split(xa.linear_v(memory)).to(cd))
            self_kv.append(torch.zeros(b * beam, maxlen, 2 * self.dim,
                                       dtype=cd, device=memory.device))
            if self.fused_layer:
                params.append(pack_layer_params(layer, pd))
                continue
            w_qkv = torch.cat([sa.linear_q.weight, sa.linear_k.weight,
                               sa.linear_v.weight])
            b_qkv = torch.cat([sa.linear_q.bias, sa.linear_k.bias,
                               sa.linear_v.bias])
            params.append(LayerParams(
                cast(layer.norm1.weight, layer.norm1.bias),
                *cast(w_qkv, b_qkv, sa.linear_out.weight, sa.linear_out.bias),
                cast(layer.norm2.weight, layer.norm2.bias),
                *cast(xa.linear_q.weight, xa.linear_q.bias,
                      xa.linear_out.weight, xa.linear_out.bias),
                cast(layer.norm3.weight, layer.norm3.bias),
                *cast(ff.w_1.weight, ff.w_1.bias, ff.w_2.weight, ff.w_2.bias),
            ))
        units = self.decoders[0].feed_forward.w_1.out_features
        return DecoderCache(
            self_kv, src_k, src_v, params,
            head_w=self.output_layer.weight.to(pd),
            pe=sinusoidal_pe(max(self.max_decode_len, maxlen), self.dim,
                             memory.device),
            scratch=(layer_scratch(b * beam, self.dim, units, memory.device)
                     if self.fused_layer and memory.is_cuda else None),
        )

    def _cross_attention(self, x, p: LayerParams, k, v, memory_mask):
        """x (N, C) with N = B*K lanes; k, v (B, H, S, Dh) shared per
        utterance: lanes fold into the query axis."""
        b, h, s, dh = k.shape
        q = F.linear(x, p.w_q_src, p.b_q_src)
        q = q.view(b, -1, h, dh).transpose(1, 2)  # (B, H, K, Dh)
        scores = torch.matmul(q, k.transpose(-1, -2).to(q.dtype)) / math.sqrt(dh)
        if memory_mask is not None:
            m = memory_mask[:, None]  # (B, 1, 1, S)
            scores = scores.float().masked_fill(~m, NEG_INF)
            attn = torch.softmax(scores, dim=-1).to(x.dtype)
            attn = attn.masked_fill(~m, 0.0)
        else:
            attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v.to(x.dtype))  # (B, H, K, Dh)
        out = out.transpose(1, 2).reshape(x.shape)
        return F.linear(out, p.w_out_src, p.b_out_src)

    def layer_step(self, i: int, x, pos, cache: DecoderCache,
                   memory_mask, bias_ksj, lanes: int):
        """Layer i of the unfused step: LN, QKV, ``decode_attention``
        (which writes the row), out-projection, cross-attention, FFN."""
        c, h = self.dim, self.heads
        p = cache.params[i]
        hn = _ln(x, p.norm1)
        qkv = F.linear(hn, p.w_qkv, p.b_qkv)  # (N, 3C)
        q = qkv[:, :c] * (c // h) ** -0.5
        out, _ = decode_attention(
            pos, q.contiguous(), cache.self_kv[i], bias_ksj, lanes, h,
            kv_row=qkv[:, c:].contiguous(),
        )
        x = x + F.linear(out.to(hn.dtype), p.w_out, p.b_out)
        x = x + self._cross_attention(_ln(x, p.norm2), p, cache.src_k[i],
                                      cache.src_v[i], memory_mask)
        hf = F.relu(F.linear(_ln(x, p.norm3), p.w_1, p.b_1))
        return x + F.linear(hf, p.w_2, p.b_2)

    def _fused_layers(self, x, pos, cache: DecoderCache, memory_mask,
                      bias_ksj, lanes: int):
        """Every layer as one ``decoder_layer_step`` launch; padded source
        rows get the additive -1e30 bias."""
        if cache.mem_bias is None or cache.mem_mask is not memory_mask:
            b, s_enc = cache.src_k[0].shape[:2]
            cache.mem_mask = memory_mask
            cache.mem_bias = (
                torch.zeros(b, s_enc, device=x.device) if memory_mask is None
                else torch.where(memory_mask[:, 0], 0.0, PAD_BIAS))
        for i, p in enumerate(cache.params):
            x, _ = decoder_layer_step(pos, x, cache.self_kv[i],
                                      cache.src_k[i], cache.src_v[i],
                                      cache.mem_bias, bias_ksj, p, lanes,
                                      self.heads, scratch=cache.scratch)
        return x

    def step(self, y_t: torch.Tensor, pos, cache: DecoderCache,
             memory_mask: Optional[torch.Tensor],
             lane_bias: torch.Tensor):
        """One decode step for N = B*K lanes: returns (log-probs (N, V) fp32,
        cache). ``pos``: the step, a one-element int tensor on the device
        (the beam's device loop: the kernels read it there, and the
        positional row is picked there) or an int. ``lane_bias`` (B, K, J,
        S): 0 where stored lane j at position s is an ancestor of lane k
        (s <= pos), -1e30 elsewhere. The self K|V buffers in ``cache`` are
        updated in place."""
        if lane_bias is None:
            raise ValueError("the decode step needs the lazy-reorder "
                             "lane_bias (B, K, J, S)")
        c = self.dim
        lanes = lane_bias.shape[1]
        bias_ksj = lane_bias.transpose(2, 3).contiguous()  # kernel layout
        row = device_step(pos, y_t.device).long().clamp_max(
            cache.pe.shape[0] - 1)
        pe = cache.pe.index_select(0, row)  # (1, C), clamped on the device
        x = self.embed[0](y_t) * math.sqrt(c) + pe
        x = x.to(self.param_dtype)
        if self.fused_layer:
            x = self._fused_layers(x, pos, cache, memory_mask, bias_ksj,
                                   lanes)
        else:
            for i in range(len(cache.params)):
                x = self.layer_step(i, x, pos, cache, memory_mask, bias_ksj,
                                    lanes)
        y = F.layer_norm(x.float(), (c,), self.after_norm.weight.float(),
                         self.after_norm.bias.float(), LN_EPS)
        logits = F.linear(y.to(cache.head_w.dtype), cache.head_w).float()
        logits = logits + self.output_layer.bias.float()
        return torch.log_softmax(logits, dim=-1), cache
