"""Flash attention: softmax(q k^T * scale + key_bias) v, forward and backward.

Counterpart of ``avsr_tpu/ops/pallas/flash_attention.py`` (``flash_attention``
and ``mha_flash`` with their custom VJP). Each wrapper dispatches on the
tensors' device: on the CPU it runs its plain PyTorch twin, on a CUDA device
it launches a hand-written kernel and counts the launch:

- ``flash_attention_fwd``: ``csrc/flash_attention.cu``, (out, lse);
- ``flash_attention_bwd_dq``: ``csrc/flash_attention_bwd.cu``, (dq, delta)
  with delta = rowsum(dO * O) computed in the kernel;
- ``flash_attention_bwd_dkv``: ``csrc/flash_attention_bwd.cu``, (dk, dv).

The forward runs on the tensor cores in both dtypes (``mma.sync``): bf16
as bf16 (``csrc/mma_bf16.cuh``; it rounds the normalised probabilities to
bf16 before P V, as the TPU kernel and the twin do), fp32 in split TF32
(each operand split into a TF32 high part and a TF32 remainder, three
TF32 products a step into fp32 accumulators, ~2^-21 of a product lost),
since one TF32 product keeps only ~3 decimal digits. The backward kernels
do the same: bf16 as bf16, fp32 in split TF32 (``csrc/mma_tf32.cuh``,
which all three fp32 kernels share).

``FlashAttentionFn`` is the autograd function over them. Attention-prob
dropout runs inside the kernels: each keep decision is drawn from
Philox4x32-10 keyed by the two seed words, at the counter of the element's
absolute (head, query row, key column), so the forward and both backward
kernels draw the same bits whatever their tiling, and nothing of size
(N, T, T) is stored. A seed may carry a head map after its two words
(``_head_map``): a tensor-parallel rank's rows then draw at their heads'
place among all of them, as one call over every head would.
``dropout_keep_mask_plain`` computes the same bits in
torch integer ops; on the CPU the twins use it, so the CPU and the card
drop the same entries for one seed. The plain twins also take an
explicit pre-scaled mask (``dropout_mask``, entries 0 or 1/keep), the JAX
CPU path's contract.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.kernels import _build

NEG_INF = -1.0e30
HEAD_DIMS = (16, 32, 64, 128)

# Philox4x32-10 (Salmon et al., SC'11; the constants of Random123/cuRAND)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def dropout_threshold(rate: float) -> tuple[int, float]:
    """(uint32 threshold, fp32-rounded 1/keep): an element is kept iff its
    32 random bits are below the threshold, round(keep * 2**32)."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in (0, 1), got {rate}")
    keep = 1.0 - rate
    thr = min(int(round(keep * 2.0**32)), _U32)
    inv_keep = torch.tensor(1.0 / keep, dtype=torch.float32).item()
    return thr, inv_keep


def _seed_words(seed: Sequence[int]) -> tuple[int, int]:
    s0, s1 = (int(s) & _U32 for s in seed[:2])
    return s0, s1


def _head_map(seed: Sequence[int]) -> tuple[int, int, int]:
    """(heads here, heads in all, first head) of a dropout seed: its words
    after the two seed words, which place a call's rows among the heads of
    a wider one (a tensor-parallel rank's heads among all of them); (1, 1,
    0), the identity, without them."""
    if len(seed) == 2:
        return 1, 1, 0
    local, total, base = (int(x) for x in seed[2:])
    if local < 1 or base < 0 or base + local > total:
        raise ValueError(f"head map ({local}, {total}, {base}): the rows' "
                         f"heads must lie among the call's")
    return local, total, base


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for uint32 values held in int64,
    in 16-bit limbs so no product leaves the int64 range."""
    p_lo = (a & 0xFFFF) * m
    s = (a >> 16) * m + (p_lo >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(c: list, k0: int, k1: int) -> list:
    """Philox4x32-10 over int64 tensors of uint32 counter words ``c``."""
    c0, c1, c2, c3 = c
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _U32
        k1 = (k1 + _PHILOX_W[1]) & _U32
    return [c0, c1, c2, c3]


def dropout_keep_mask_plain(seed: Sequence[int], n: int, t: int, rate: float,
                            device=None) -> torch.Tensor:
    """(n, t, t) bool keep mask, bit for bit the kernels' draw: element
    (row n, query i, key j) is word ``j & 3`` of Philox4x32-10 at counter
    (j >> 2, i, h, 0) under key (seed[0], seed[1]), kept iff below
    ``dropout_threshold(rate)[0]``. The head h is the row n itself, or,
    with a head map in ``seed`` (local, total, base; ``_head_map``), row n
    of a call whose rows are (batch, local head) taken as head ``base`` +
    n % local of ``total`` heads: h = (n // local) * total + base + n %
    local."""
    thr, _ = dropout_threshold(rate)
    k0, k1 = _seed_words(seed)
    local, total, base = _head_map(seed)
    groups = (t + 3) // 4

    def ar(m):
        return torch.arange(m, dtype=torch.int64, device=device)

    c0 = ar(groups).view(1, 1, groups).expand(n, t, groups)
    c1 = ar(t).view(1, t, 1).expand(n, t, groups)
    rows = ar(n)
    heads = (rows // local) * total + base + rows % local
    c2 = heads.view(n, 1, 1).expand(n, t, groups)
    words = philox4x32_10([c0, c1, c2, torch.zeros_like(c0)], k0, k1)
    bits = torch.stack(words, dim=-1).reshape(n, t, groups * 4)[..., :t]
    return bits < thr


def _seeded_mask(rate, seed, n, t, device):
    """The pre-scaled fp32 mask (0 or fp32(1/keep)) the kernels apply."""
    _, inv_keep = dropout_threshold(rate)
    keep = dropout_keep_mask_plain(seed, n, t, rate, device)
    return keep.to(torch.float32) * inv_keep


def _twin_mask(q, dropout_mask, dropout_rate, dropout_seed):
    if dropout_rate > 0.0:
        if dropout_mask is not None:
            raise ValueError("pass dropout_mask or dropout_rate, not both")
        n, t, _ = q.shape
        return _seeded_mask(dropout_rate, dropout_seed, n, t, q.device)
    return dropout_mask


def flash_attention_plain(q, k, v, key_bias, scale: float = 1.0,
                          dropout_mask: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0,
                          dropout_seed: Optional[Sequence[int]] = None):
    """Plain torch twin with the TPU resident kernel's numerics: fp32
    scores, probabilities normalised (after the pre-scaled dropout mask,
    if any) then cast to v's dtype before the value product (fp32
    accumulation). Returns (out (N,T,D), lse (N,T))."""
    mask = _twin_mask(q, dropout_mask, dropout_rate, dropout_seed)
    s = torch.einsum("ntd,nsd->nts", q.float(), k.float()) * scale
    s = s + key_bias.float()[:, None, :]
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    if mask is None:
        pv = (p / l[..., None]).to(v.dtype).float()
    else:
        pv = ((p * mask.float()) / l[..., None]).to(v.dtype).float()
    out = torch.einsum("nts,nsd->ntd", pv, v.float()).to(q.dtype)
    return out, m + torch.log(l)


def attention_delta_plain(out, do) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32 (N, T); under dropout it equals
    rowsum(P o dP~), the identity the backward uses."""
    return (do.float() * out.float()).sum(dim=-1)


def _bwd_from_delta(q, k, v, key_bias, do, lse, delta, scale, mask):
    """dQ, dK, dV with the resident kernel's formula (flash_attention.py
    :359-393): P recomputed from lse; the dropped P~ and dS cast to the
    operand dtype before their products; fp32 accumulation."""
    f32 = torch.float32
    s = torch.einsum("ntd,nsd->nts", q.float(), k.float()) * scale
    p = torch.exp(s + key_bias.float()[:, None, :] - lse[..., None])
    pm = p if mask is None else p * mask.float()
    dv = torch.einsum("nts,ntd->nsd", pm.to(do.dtype).float(), do.float())
    dp = torch.einsum("ntd,nsd->nts", do.float(), v.float())
    if mask is not None:
        dp = dp * mask.float()
    ds = (p * (dp - delta[..., None])).to(q.dtype).to(f32)
    dq = torch.einsum("nts,nsd->ntd", ds, k.float()) * scale
    dk = torch.einsum("nts,ntd->nsd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, key_bias, out, do, lse,
                              scale: float = 1.0,
                              dropout_mask: Optional[torch.Tensor] = None,
                              dropout_rate: float = 0.0,
                              dropout_seed: Optional[Sequence[int]] = None):
    """Plain twin of the backward: (dq, dk, dv) for the upstream gradient
    ``do`` of ``out`` = flash attention of (q, k, v), whose row
    logsumexp is ``lse``. Explicit math, no autograd."""
    mask = _twin_mask(q, dropout_mask, dropout_rate, dropout_seed)
    return _bwd_from_delta(q, k, v, key_bias, do, lse,
                           attention_delta_plain(out, do), scale, mask)


# ---------------------------------------------------------------- kernels


def _check(q, k, v, key_bias, *rest):
    """q, k, v (N, T, D) of one dtype; key_bias fp32 (N, T); each of
    ``rest`` either (N, T, D) in q's dtype (out, dO) or fp32 (N, T) row
    statistics (lse, delta). All contiguous, on one device."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q/k/v must share one (N, T, D) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    n, t, d = q.shape
    if key_bias.shape != (n, t) or key_bias.dtype != torch.float32:
        raise ValueError(f"key_bias must be fp32 ({n}, {t}), got "
                         f"{key_bias.dtype} {tuple(key_bias.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    for x in rest:
        if not ((x.shape == q.shape and x.dtype == q.dtype)
                or (x.shape == (n, t) and x.dtype == torch.float32)):
            raise ValueError(f"operand {x.dtype} {tuple(x.shape)} is neither "
                             f"{q.dtype} {tuple(q.shape)} nor fp32 ({n}, {t})")
    devs = {x.device for x in (q, k, v, key_bias, *rest)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {devs}")
    for x in (q, k, v, key_bias, *rest):
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash_attention for device {q.device}")


def _aligned(*operands):
    """The operands, each copied into a fresh tensor (which the caching
    allocator aligns) where one does not start 16-byte aligned: the
    tensor-core kernels copy 16-byte chunks, and the TPU kernel takes any
    array."""
    return tuple(x.clone() if x.data_ptr() % 16 else x for x in operands)


def _kernel_args(q, dropout_rate, dropout_seed, *operands):
    """Checks the card-side operands (q and the other (N, T, D) tensors
    ``operands``); returns the dropout arguments (rate flag, uint32
    threshold, 1/keep, seed words, head map)."""
    n, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dims {HEAD_DIMS}; got {d}")
    if any(x.data_ptr() % 16 for x in (q, *operands)):
        raise ValueError("the kernels copy 16-byte chunks: (N, T, D) "
                         "operands must start 16-byte aligned")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate needs dropout_seed")
        thr, inv_keep = dropout_threshold(dropout_rate)
        return (1, thr, inv_keep, *_seed_words(dropout_seed),
                *_head_map(dropout_seed))
    return (0, 0, 1.0, 0, 0, 1, 1, 0)


_DROP_ARGTYPES = (ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
                  ctypes.c_uint32, ctypes.c_uint32) + (ctypes.c_int,) * 3
_SIZE_ARGTYPES = (ctypes.c_int,) * 3 + (ctypes.c_float,)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_attention_fwd(q, k, v, key_bias, scale: float = 1.0,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[Sequence[int]] = None):
    """(out (N, T, D) in q's dtype, lse (N, T) fp32) for q, k, v (N, T, D)
    in fp32 or bf16 and an fp32 additive key_bias (N, T). With
    ``dropout_rate`` > 0 the normalised probabilities are dropped at the
    seeded draw and rescaled by 1/keep; lse stays the undropped
    normaliser's."""
    _check(q, k, v, key_bias)
    if q.device.type == "cpu":
        warm_exp()
        return flash_attention_plain(q, k, v, key_bias, scale,
                                     dropout_rate=dropout_rate,
                                     dropout_seed=dropout_seed)
    q, k, v = _aligned(q, k, v)
    drop = _kernel_args(q, dropout_rate, dropout_seed, k, v)
    n, t, d = q.shape
    fn = _build.function(
        "avsr_flash_attention_fwd",
        (ctypes.c_void_p,) * 6 + _SIZE_ARGTYPES + _DROP_ARGTYPES
        + (ctypes.c_int, ctypes.c_void_p),
    )
    out = torch.empty_like(q)
    lse = torch.empty((n, t), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
             out.data_ptr(), lse.data_ptr(), n, t, d, float(scale), *drop,
             _build.dtype_code(q.dtype), _stream(q))
    _build.check("flash_attention_fwd", err)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q, k, v, key_bias, out, do, lse,
                           scale: float = 1.0, dropout_rate: float = 0.0,
                           dropout_seed: Optional[Sequence[int]] = None):
    """(dq (N, T, D) in q's dtype, delta (N, T) fp32): the query gradient
    and delta = rowsum(dO * O), which ``flash_attention_bwd_dkv`` takes.

    On the card: ``flash_bwd_dq_mma`` (bf16) or ``flash_bwd_dq_tf32``
    (fp32), the counterpart of the TPU kernels ``_resident_bwd_kernel`` and
    ``_flash_bwd_dq_kernel``. One block of four warps per (head, 64-query
    tile) recomputes S = Q K^T and dP = dO V^T over streamed key tiles and
    adds dS K, on the tensor cores; in fp32 each product is three TF32
    products of the operands' split halves. Bound: its three T x T x D
    products, at the tensor cores' peak for the type (fp32: three TF32
    products each, 0.033 ms at N = 96, T = 384, D = 64); the integer and
    exp work of the splits and the probabilities is what holds it there."""
    _check(q, k, v, key_bias, out, do, lse)
    if q.device.type == "cpu":
        warm_exp()
        delta = attention_delta_plain(out, do)
        mask = _twin_mask(q, None, dropout_rate, dropout_seed)
        dq = _bwd_from_delta(q, k, v, key_bias, do, lse, delta, scale,
                             mask)[0]
        return dq, delta
    q, k, v, out, do = _aligned(q, k, v, out, do)
    drop = _kernel_args(q, dropout_rate, dropout_seed, k, v, out, do)
    n, t, d = q.shape
    fn = _build.function(
        "avsr_flash_attention_bwd_dq",
        (ctypes.c_void_p,) * 9 + _SIZE_ARGTYPES + _DROP_ARGTYPES
        + (ctypes.c_int, ctypes.c_void_p),
    )
    dq = torch.empty_like(q)
    delta = torch.empty((n, t), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
             out.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
             delta.data_ptr(), n, t, d, float(scale), *drop,
             _build.dtype_code(q.dtype), _stream(q))
    _build.check("flash_attention_bwd_dq", err)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, key_bias, do, lse, delta,
                            scale: float = 1.0, dropout_rate: float = 0.0,
                            dropout_seed: Optional[Sequence[int]] = None):
    """(dk, dv), each (N, T, D) in the operand dtype, given the row
    statistics lse and delta of the forward and ``flash_attention_bwd_dq``.

    On the card: ``flash_bwd_dkv_mma`` (bf16) or ``flash_bwd_dkv_tf32``
    (fp32), the counterpart of ``_resident_bwd_kernel`` and
    ``_flash_bwd_dkv_kernel``. One block of four warps per (head, 64-key
    tile) recomputes S^T and dP^T over streamed query tiles (with their
    lse and delta) and adds P~^T dO and dS^T Q, on the tensor cores; in
    fp32 in split TF32, as dq. Bound: four T x T x D products (fp32:
    0.044 ms at N = 96, T = 384, D = 64)."""
    _check(q, k, v, key_bias, do, lse, delta)
    if q.device.type == "cpu":
        warm_exp()
        mask = _twin_mask(q, None, dropout_rate, dropout_seed)
        return _bwd_from_delta(q, k, v, key_bias, do, lse, delta, scale,
                               mask)[1:]
    q, k, v, do = _aligned(q, k, v, do)
    drop = _kernel_args(q, dropout_rate, dropout_seed, k, v, do)
    n, t, d = q.shape
    fn = _build.function(
        "avsr_flash_attention_bwd_dkv",
        (ctypes.c_void_p,) * 9 + _SIZE_ARGTYPES + _DROP_ARGTYPES
        + (ctypes.c_int, ctypes.c_void_p),
    )
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), n, t, d, float(scale), *drop,
             _build.dtype_code(q.dtype), _stream(q))
    _build.check("flash_attention_bwd_dkv", err)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, key_bias, out, do, lse, scale: float = 1.0,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[Sequence[int]] = None):
    """(dq, dk, dv): the dq pass (which also writes delta), then the dk/dv
    pass. Two kernels, so dQ is written by one block per query tile and
    dK/dV by one block per key tile: no atomics, deterministic sums."""
    dq, delta = flash_attention_bwd_dq(q, k, v, key_bias, out, do, lse,
                                       scale, dropout_rate, dropout_seed)
    dk, dv = flash_attention_bwd_dkv(q, k, v, key_bias, do, lse, delta,
                                     scale, dropout_rate, dropout_seed)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention over (N, T, D) rows; the key bias and
    the dropout arguments take no gradient. Saves q, k, v, out and lse
    (O(N T D)); the backward recomputes P from lse."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, scale, dropout_rate=0.0,
                dropout_seed=None):
        out, lse = flash_attention_fwd(q, k, v, key_bias, scale,
                                       dropout_rate, dropout_seed)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.scale, ctx.rate, ctx.seed = scale, dropout_rate, dropout_seed
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, key_bias, out,
                                         do.contiguous(), lse, ctx.scale,
                                         ctx.rate, ctx.seed)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, key_bias, scale: float = 1.0,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[Sequence[int]] = None):
    """Attention output only, as the JAX ``flash_attention`` returns;
    differentiable in q, k and v."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, key_bias, scale, dropout_rate,
                                      dropout_seed)
    return flash_attention_fwd(q, k, v, key_bias, scale, dropout_rate,
                               dropout_seed)[0]


def mha_flash(q, k, v, padding_mask: Optional[torch.Tensor], scale: float,
              block: int = 128, dropout_rate: float = 0.0,
              dropout_seed: Optional[Sequence[int]] = None):
    """Multi-head wrapper: (B, T, H, Dh) -> (B, T, H, Dh).

    As the JAX ``mha_flash``: T is padded to a multiple of ``block`` and the
    padding, with any padded frames of ``padding_mask`` (B, T, True =
    valid), enters as a -1e30 key bias. With ``dropout_rate`` > 0 the
    attention probabilities are dropped inside the kernels at the draw of
    ``dropout_seed`` (two uint32 words, and optionally a head map: these
    H heads are heads base..base+H-1 of ``total``, ``_head_map``) over the
    padded (B*H, T', T')."""
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
        # at b = 1 the reshape is a strided view: the kernels take rows
        return x.permute(0, 2, 1, 3).reshape(b * h, tp, dh).contiguous()

    out = flash_attention(
        to_rows(q), to_rows(k), to_rows(v),
        bias.repeat_interleave(h, dim=0), scale=scale,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
    )
    return out.view(b, h, tp, dh).permute(0, 2, 1, 3)[:, :t]
