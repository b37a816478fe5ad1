"""Flash-attention forward: softmax(q k^T * scale + key_bias) v.

Counterpart of ``avsr_tpu/ops/pallas/flash_attention.py`` (``flash_attention``
and ``mha_flash``, forward only). ``flash_attention_fwd`` dispatches on the
tensors' device: on the CPU it runs ``flash_attention_plain``, on a CUDA
device it launches the hand-written kernel ``csrc/flash_attention.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from avsr_tpu_torch.ops.kernels import _build

NEG_INF = -1.0e30


def flash_attention_plain(q, k, v, key_bias, scale: float = 1.0):
    """Plain torch twin with the TPU resident kernel's numerics: fp32
    scores, probabilities normalised then cast to v's dtype before the
    value product (fp32 accumulation). Returns (out (N,T,D), lse (N,T))."""
    s = torch.einsum("ntd,nsd->nts", q.float(), k.float()) * scale
    s = s + key_bias.float()[:, None, :]
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    pv = (p / l[..., None]).to(v.dtype).float()
    out = torch.einsum("nts,nsd->ntd", pv, v.float()).to(q.dtype)
    return out, m + torch.log(l)


def _check(q, k, v, key_bias):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q/k/v must share one (N, T, D) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    n, t, d = q.shape
    if key_bias.shape != (n, t) or key_bias.dtype != torch.float32:
        raise ValueError(f"key_bias must be fp32 ({n}, {t}), got "
                         f"{key_bias.dtype} {tuple(key_bias.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    devs = {x.device for x in (q, k, v, key_bias)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {devs}")
    for x in (q, k, v, key_bias):
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")


def _launch(q, k, v, key_bias, scale):
    n, t, d = q.shape
    if d not in (16, 32, 64, 128):
        raise ValueError(f"kernel takes head dims 16, 32, 64, 128; got {d}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    fn = _build.function(
        "avsr_flash_attention_fwd",
        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3
        + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p),
    )
    out = torch.empty_like(q)
    lse = torch.empty((n, t), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
             out.data_ptr(), lse.data_ptr(), n, t, d, float(scale),
             _build.dtype_code(q.dtype),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention_fwd", err)
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, key_bias, scale: float = 1.0):
    """(out (N, T, D) in q's dtype, lse (N, T) fp32) for q, k, v (N, T, D)
    in fp32 or bf16 and an fp32 additive key_bias (N, T)."""
    _check(q, k, v, key_bias)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    return _launch(q, k, v, key_bias, scale)


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, key_bias, scale: float = 1.0):
    """Attention output only, as the JAX ``flash_attention`` returns."""
    return flash_attention_fwd(q, k, v, key_bias, scale)[0]


def mha_flash(q, k, v, padding_mask: Optional[torch.Tensor], scale: float,
              block: int = 128):
    """Multi-head wrapper: (B, T, H, Dh) -> (B, T, H, Dh).

    As the JAX ``mha_flash``: T is padded to a multiple of ``block`` and the
    padding, with any padded frames of ``padding_mask`` (B, T, True =
    valid), enters as a -1e30 key bias."""
    b, t, h, dh = q.shape
    pad = (-t) % block
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                   for x in (q, k, v))
    tp = t + pad
    if padding_mask is None:
        valid = torch.arange(tp, device=q.device)[None, :] < t
        valid = valid.expand(b, tp)
    else:
        valid = torch.nn.functional.pad(padding_mask, (0, pad), value=False)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)

    def to_rows(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, tp, dh)

    out = flash_attention(
        to_rows(q), to_rows(k), to_rows(v),
        bias.repeat_interleave(h, dim=0), scale=scale,
    )
    return out.view(b, h, tp, dh).permute(0, 2, 1, 3)[:, :t]
