"""Decode-step self-attention with lazy beam reorder and in-kernel row write.

Counterpart of ``avsr_tpu/ops/pallas/decode_attention.py``
(``decode_attention`` with ``kv_row``, resident v3). ``decode_attention``
dispatches on the tensors' device: on the CPU it runs
``decode_attention_plain``, on a CUDA device it launches
``csrc/decode_attention.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from avsr_tpu_torch.ops.kernels import _build


def decode_attention_plain(pos: int, q, kv_cache, lane_bias, lanes: int,
                           heads: int, kv_row):
    """Plain torch twin. Writes ``kv_row`` into row min(pos, S-1) of
    ``kv_cache`` in place, then attends with the TPU kernel's rounding
    points: q and the normalised probabilities are cast to the cache dtype
    before their products, which accumulate in fp32."""
    n, s_max, c2 = kv_cache.shape
    c = c2 // 2
    b = n // lanes
    dh = c // heads
    kv_cache[:, min(pos, s_max - 1)] = kv_row.to(kv_cache.dtype)
    kv = kv_cache.view(b, lanes, s_max, 2, heads, dh).float()
    qq = q.to(kv_cache.dtype).float().view(b, lanes, heads, dh)
    scores = torch.einsum("bkhd,bjshd->bhkjs", qq, kv[:, :, :, 0])
    scores = scores + lane_bias.permute(0, 1, 3, 2)[:, None]  # (B,1,K,J,S)
    flat = scores.reshape(b, heads, lanes, lanes * s_max)
    m = flat.amax(dim=-1, keepdim=True)
    p = torch.exp(flat - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = p.to(kv_cache.dtype).float().view(b, heads, lanes, lanes, s_max)
    out = torch.einsum("bhkjs,bjshd->bkhd", p, kv[:, :, :, 1])
    return out.reshape(n, c).to(q.dtype), kv_cache


def _check(pos, q, kv_cache, lane_bias, lanes, heads, kv_row):
    if kv_cache.dim() != 3 or kv_cache.shape[2] % 2:
        raise ValueError(f"kv_cache must be (N, S, 2C), got "
                         f"{tuple(kv_cache.shape)}")
    n, s_max, c2 = kv_cache.shape
    c = c2 // 2
    if n % lanes or c % heads:
        raise ValueError(f"N={n} / lanes={lanes} or C={c} / heads={heads} "
                         "does not divide")
    b = n // lanes
    if q.shape != (n, c):
        raise ValueError(f"q must be ({n}, {c}), got {tuple(q.shape)}")
    if kv_row.shape != (n, c2):
        raise ValueError(f"kv_row must be ({n}, {c2}), got "
                         f"{tuple(kv_row.shape)}")
    if lane_bias.shape != (b, lanes, s_max, lanes) or (
            lane_bias.dtype != torch.float32):
        raise ValueError(f"lane_bias must be fp32 ({b}, {lanes}, {s_max}, "
                         f"{lanes}), got {lane_bias.dtype} "
                         f"{tuple(lane_bias.shape)}")
    if int(pos) < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    devs = {x.device for x in (q, kv_cache, lane_bias, kv_row)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {devs}")
    for x in (q, kv_cache, lane_bias, kv_row):
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")


def _launch(pos, q, kv_cache, lane_bias, lanes, heads, kv_row):
    n, s_max, c2 = kv_cache.shape
    dh = c2 // 2 // heads
    vec = 16 // kv_cache.element_size()  # cache elements per 16-byte chunk
    cpr = dh // vec
    if dh % vec or cpr > 32 or cpr & (cpr - 1) or lanes > 8:
        raise ValueError(f"kernel takes head dims of 1-32 16-byte chunks (a "
                         f"power of two) and <= 8 lanes, got dh={dh}, "
                         f"lanes={lanes}")
    if kv_cache.data_ptr() % 16:
        raise ValueError("kv_cache must be 16-byte aligned")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    fn = _build.function(
        "avsr_decode_attention",
        (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,),
    )
    kv_row = kv_row.to(kv_cache.dtype)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), kv_cache.data_ptr(), lane_bias.data_ptr(),
             kv_row.data_ptr(), out.data_ptr(), n // lanes, lanes, heads, dh,
             s_max, int(pos), _build.dtype_code(q.dtype),
             _build.dtype_code(kv_cache.dtype),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err)
    decode_attention.launches += 1
    return out, kv_cache


def decode_attention(pos: int, q, kv_cache, lane_bias, lanes: int,
                     heads: int, kv_row):
    """One decode step's self-attention for all N = B*lanes beam lanes.

    pos: the step's position (int); q (N, C) queries pre-scaled by
    dh**-0.5; kv_cache (N, S, 2C) fused K|V; lane_bias (B, K, S, J) fp32,
    0 where stored lane j at position s is an ancestor of lane k and
    -1e30 elsewhere, including every s > pos on every lane (the kernel
    skips those rows); kv_row (N, 2C) this step's K|V row.

    The row is written at min(pos, S-1) IN PLACE: the returned cache is
    ``kv_cache`` itself. Returns (out (N, C) in q's dtype, kv_cache)."""
    _check(pos, q, kv_cache, lane_bias, lanes, heads, kv_row)
    if q.device.type == "cpu":
        return decode_attention_plain(pos, q, kv_cache, lane_bias, lanes,
                                      heads, kv_row)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {q.device}")
    return _launch(pos, q, kv_cache, lane_bias, lanes, heads, kv_row)


decode_attention.launches = 0
