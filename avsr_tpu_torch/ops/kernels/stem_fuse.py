"""The lip stem's tail fused: BatchNorm + PReLU + 3x3/s2/p1 max-pool.

Counterpart of ``avsr_tpu/ops/pallas/stem_fuse.py`` (``bn_prelu_pool``)
over (N, C, H, W) frames, H and W even. ``bn_prelu_pool`` dispatches on the
device: CPU tensors run the plain twins (``bn_prelu_pool_plain``,
``bn_prelu_pool_bwd1_plain``, ``bn_prelu_pool_bwd2_plain``), CUDA tensors
launch the four kernels of
``csrc/stem_fuse.cu``, each counting its launches. The kernels read and
write channels-last frames (``torch.channels_last``): the layout of the
stem's Conv3d output on the card, which ``ResEncoder`` folds into frames as
a view, and the TPU kernel's NHWC.

- ``bn_prelu_pool_stats``: per-channel sum and sum of squares (training);
- ``bn_prelu_pool_apply``: z = x * g + b in fp32 (g = scale * rstd,
  b = bias - mean * scale * rstd, the TPU kernel's form), PReLU, the max
  over each 3x3 window, cast to x's dtype;
- ``bn_prelu_pool_bwd1``: recomputes y, routes the cotangent to the first
  maximum of each window in row-major order, dz = where(z < 0, alpha dy,
  dy) stored in x's dtype, and the channel sums of dz, dz * xhat and
  where(z < 0, dy * z, 0);
- ``bn_prelu_pool_bwd2``: dx = scale * rstd * (dz - dbeta/M - xhat dgamma/M).

Training normalises with the batch statistics (biased variance
E[x^2] - mean^2, not clamped) and returns them, without gradient, for the
running averages; the backward saves x alone and recomputes the rest.
Under data parallelism the statistics are the global batch's: the stats'
sums and bwd1's sums are all-reduced over the data group (``core/dist``)
between the kernels, on either device. The
parameter gradients come back in the dtypes the parameters arrived in.
Eval normalises with the running statistics. Arithmetic runs in fp32; on
the CPU a float64 input keeps fp32 statistics and folded g, b, as the
JAX package's ``lean_reference`` does, and is otherwise float64.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.nn import functional as F

from avsr_tpu_torch.core import dist
from avsr_tpu_torch.ops.kernels import _build


def _compute_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


def _ch(v, cd):  # (C,) -> (1, C, 1, 1) in the compute dtype
    return v.to(cd).view(1, -1, 1, 1)


def _affine(mean, rstd, scale, bias):
    """(g, b) of z = x * g + b, in the TPU kernel's order of operations."""
    return scale * rstd, bias - mean * scale * rstd


def _batch_stats_plain(xa):
    n, _, h, w = xa.shape
    m = float(n * h * w)
    mean = xa.sum(dim=(0, 2, 3)) / m
    var = (xa * xa).sum(dim=(0, 2, 3)) / m - mean * mean
    return mean, var


def bn_prelu_pool_plain(x, scale, bias, alpha, *, eps: float = 1e-5,
                        train: bool, running_mean=None, running_var=None):
    """Plain torch twin of ``bn_prelu_pool`` (its forward): (pooled, mean,
    var) in training, pooled in eval. The statistics and the folded g, b
    are fp32, as the kernels' parameters are (and as ``lean_reference``
    keeps them for any activation dtype)."""
    cd = _compute_dtype(x)
    xa = x.to(cd)
    if train:
        mean, var = _batch_stats_plain(x.float())
    else:
        mean, var = running_mean.float(), running_var.float()
    rstd = torch.rsqrt(var + eps)
    g, b = _affine(mean, rstd, scale.float(), bias.float())
    z = xa * _ch(g, cd) + _ch(b, cd)
    y = torch.where(z >= 0, z, _ch(alpha, cd) * z)
    out = F.max_pool2d(y, 3, stride=2, padding=1).to(x.dtype)
    return (out, mean, var) if train else out


def _pool_candidates(y):
    """The 9 window candidates (N, C, H/2, W/2) of the -inf padded y, in
    row-major window order k = 3 i + j, and the padded shape."""
    h, w = y.shape[2:]
    yp = F.pad(y, (1, 1, 1, 1), value=float("-inf"))
    return [yp[:, :, i:i + h:2, j:j + w:2] for i in range(3)
            for j in range(3)], yp.shape


def pool_bwd_plain(y, dout):
    """The max-pool's backward: dout (N, C, H/2, W/2) routed to the first
    maximum of each window in row-major order (XLA's select-and-scatter),
    the contributions to a position added in ascending k."""
    h, w = y.shape[2:]
    cands, padded = _pool_candidates(y)
    winmax = torch.stack(cands).amax(dim=0)
    prev = torch.full_like(winmax, float("-inf"))
    dyp = torch.zeros(padded, dtype=y.dtype, device=y.device)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    for k, ck in enumerate(cands):
        i, j = divmod(k, 3)
        hot = (ck == winmax) & (prev < winmax)
        dyp[:, :, i:i + h:2, j:j + w:2] += torch.where(hot, dout, zero)
        prev = torch.maximum(prev, ck)
    return dyp[:, :, 1:h + 1, 1:w + 1]


def bn_prelu_pool_bwd1_plain(x, scale, bias, alpha, mean, rstd, dout):
    """Plain torch twin of ``bn_prelu_pool_bwd1``: (dz in x's dtype, dgamma,
    dbeta, dalpha in the compute dtype), dout already in x's dtype; mean
    and rstd fp32."""
    cd = _compute_dtype(x)
    xa = x.to(cd)
    g, b = _affine(mean, rstd, scale.float(), bias.float())
    z = xa * _ch(g, cd) + _ch(b, cd)
    neg = z < 0
    al = _ch(alpha, cd)
    y = torch.where(neg, al * z, z)
    dy = pool_bwd_plain(y, dout.to(cd))
    dz = torch.where(neg, al * dy, dy)
    xhat = (xa - _ch(mean, cd)) * _ch(rstd, cd)
    dbeta = dz.sum(dim=(0, 2, 3))
    dgamma = (dz * xhat).sum(dim=(0, 2, 3))
    dalpha = torch.where(neg, dy * z, 0.0).sum(dim=(0, 2, 3))
    return dz.to(x.dtype), dgamma, dbeta, dalpha


def bn_prelu_pool_bwd2_plain(x, scale, mean, rstd, dz, dgamma, dbeta,
                             count: Optional[float] = None):
    """Plain torch twin of ``bn_prelu_pool_bwd2``: dx = scale * rstd *
    (dz - dbeta/M - xhat dgamma/M) in x's dtype, dz in x's dtype; M is
    ``count``, the frames' positions (N H W) unless the statistics span
    more (data parallelism: the global batch's, with dgamma and dbeta its
    sums)."""
    cd = _compute_dtype(x)
    n, _, h, w = x.shape
    m = float(n * h * w) if count is None else float(count)
    rstd = _ch(rstd, cd)
    xhat = (x.to(cd) - _ch(mean, cd)) * rstd
    dx = _ch(scale, cd) * rstd * (
        dz.to(cd) - _ch(dbeta / m, cd) - xhat * _ch(dgamma / m, cd))
    return dx.to(x.dtype)


def bn_prelu_pool_bwd_plain(x, scale, bias, alpha, mean, rstd, dout):
    """Plain torch twin of the backward: (dx in x's dtype, dscale, dbias,
    dalpha in the compute dtype), dout already in x's dtype; mean and rstd
    fp32. dz is stored in x's dtype between the two passes, as the kernels
    store it."""
    dz, dgamma, dbeta, dalpha = bn_prelu_pool_bwd1_plain(
        x, scale, bias, alpha, mean, rstd, dout)
    dx = bn_prelu_pool_bwd2_plain(x, scale, mean, rstd, dz, dgamma, dbeta)
    return dx, dgamma, dbeta, dalpha


# ---------------------------------------------------------------- kernels


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _pack(*rows):
    """(len(rows), C) fp32 kernel parameters."""
    return torch.stack([r.float() for r in rows]).contiguous()


MAX_BLOCKS = 1024  # blocks of the reducing kernels (csrc), a partial row each
CL = torch.channels_last


def _frames(*tensors):
    """The kernels' tensors must be channels-last (N, C, H, W)."""
    for t in tensors:
        if t.dim() != 4 or not t.is_contiguous(memory_format=CL):
            raise ValueError(f"the stem kernels take channels_last (N, C, H, "
                             f"W) tensors, got {tuple(t.shape)} with strides "
                             f"{t.stride()}")


def _sum_scratch(x, k):
    """The partials and the zeroed block counter of a reducing kernel."""
    return (torch.empty(MAX_BLOCKS * k * x.shape[1], dtype=torch.float32,
                        device=x.device),
            torch.zeros(1, dtype=torch.int32, device=x.device))


def bn_prelu_pool_stats(x):
    """(sum, sum of squares), each (C,) fp32, over (N, H, W)."""
    _frames(x)
    n, c, h, w = x.shape
    fn = _build.function("avsr_bn_stats", (ctypes.c_void_p,) * 4
                         + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    partial, counter = _sum_scratch(x, 2)
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), partial.data_ptr(), counter.data_ptr(),
             sums.data_ptr(), n, c, h, w, _build.dtype_code(x.dtype),
             _stream(x))
    _build.check("bn_prelu_pool_stats", err)
    bn_prelu_pool_stats.launches += 1
    return sums[0], sums[1]


bn_prelu_pool_stats.launches = 0


def bn_prelu_pool_apply(x, p):
    """The pooled (N, C, H/2, W/2) output in x's dtype, channels-last; p
    (5, C) fp32 rows mean, rstd, scale, bias, alpha."""
    _frames(x)
    n, c, h, w = x.shape
    fn = _build.function("avsr_bn_apply", (ctypes.c_void_p,) * 3
                         + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    out = torch.empty(n, c, h // 2, w // 2, dtype=x.dtype, device=x.device,
                      memory_format=CL)
    err = fn(x.data_ptr(), p.data_ptr(), out.data_ptr(), n, c, h, w,
             _build.dtype_code(x.dtype), _stream(x))
    _build.check("bn_prelu_pool_apply", err)
    bn_prelu_pool_apply.launches += 1
    return out


bn_prelu_pool_apply.launches = 0


def bn_prelu_pool_bwd1(x, p, dout):
    """(dz (N, C, H, W) in x's dtype, channels-last, red (3, C) fp32: the
    sums of dz, dz * xhat and where(z < 0, dy * z, 0)); dout in x's dtype."""
    _frames(x, dout)
    n, c, h, w = x.shape
    fn = _build.function("avsr_bn_bwd1", (ctypes.c_void_p,) * 7
                         + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    dz = torch.empty_like(x, memory_format=CL)
    partial, counter = _sum_scratch(x, 3)
    red = torch.empty(3, c, dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), p.data_ptr(), dout.data_ptr(), dz.data_ptr(),
             partial.data_ptr(), counter.data_ptr(), red.data_ptr(), n, c, h,
             w, _build.dtype_code(x.dtype), _stream(x))
    _build.check("bn_prelu_pool_bwd1", err)
    bn_prelu_pool_bwd1.launches += 1
    return dz, red


bn_prelu_pool_bwd1.launches = 0


def bn_prelu_pool_bwd2(x, p2, dz):
    """dx (N, C, H, W) in x's dtype, channels-last; p2 (5, C) fp32 rows
    mean, rstd, scale * rstd, dbeta / M, dgamma / M."""
    _frames(x, dz)
    n, c, h, w = x.shape
    fn = _build.function("avsr_bn_bwd2", (ctypes.c_void_p,) * 4
                         + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    dx = torch.empty_like(x, memory_format=CL)
    err = fn(x.data_ptr(), p2.data_ptr(), dz.data_ptr(), dx.data_ptr(), n, c,
             h, w, _build.dtype_code(x.dtype), _stream(x))
    _build.check("bn_prelu_pool_bwd2", err)
    bn_prelu_pool_bwd2.launches += 1
    return dx


bn_prelu_pool_bwd2.launches = 0


def _check(x, *params):
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"x must be (N, C, H, W) with H and W even, got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    for p in params:
        if p is None or p.shape != (c,):
            raise ValueError(f"per-channel parameters must be ({c},)")
        if p.device != x.device:
            raise ValueError(f"inputs span devices {x.device}, {p.device}")
    if x.device.type == "cuda":
        if x.device.index != torch.cuda.current_device():
            raise ValueError(f"x on {x.device}, current device is "
                             f"cuda:{torch.cuda.current_device()}")
        _build.dtype_code(x.dtype)
    elif x.device.type != "cpu":
        raise ValueError(f"no bn_prelu_pool for device {x.device}")


def _global_sums(rows, count=None):
    """(rows, count) summed over the data group in one collective, count
    (a number of positions) optional; as they are on one rank."""
    if dist.data_size() == 1:
        return rows, count
    flat = [torch.stack([r.float() for r in rows]).reshape(-1)]
    if count is not None:
        flat.append(rows[0].new_full((1,), count, dtype=torch.float32))
    packed = dist.all_reduce_(torch.cat(flat))
    k = len(rows) * rows[0].numel()
    return (list(packed[:k].view(len(rows), -1)),
            None if count is None else packed[k])


def _train_forward(x, scale, bias, alpha, eps):
    """(out, mean, var, rstd, count) of the training forward on either
    device: the channel sums (the stats kernel, or the twin's), summed
    over the data group with the count of positions, the statistics from
    them, then the apply (kernel or twin)."""
    n, _, h, w = x.shape
    if x.device.type == "cpu":
        xa = x.float()
        sums = [xa.sum(dim=(0, 2, 3)), (xa * xa).sum(dim=(0, 2, 3))]
    else:
        sums = list(bn_prelu_pool_stats(x))
    (s, q), m = _global_sums(sums, float(n * h * w))
    mean = s / m
    var = q / m - mean * mean
    rstd = torch.rsqrt(var + eps)
    if x.device.type == "cpu":
        out = bn_prelu_pool_plain(x, scale, bias, alpha, eps=eps, train=False,
                                  running_mean=mean, running_var=var)
    else:
        out = bn_prelu_pool_apply(x, _pack(mean, rstd, scale, bias, alpha))
    return out, mean, var, rstd, m


class BnPreluPoolFn(torch.autograd.Function):
    """Training-mode ``bn_prelu_pool``, differentiable in x, scale, bias and
    alpha; the batch mean and var are returned without gradient. Saves x
    and the (C,) statistics; the backward recomputes z, y and the pool's
    routing. Under data parallelism the statistics are the global
    batch's (the stats kernel's sums and the count all-reduced over the
    data group before the apply), and bwd1's sums of dz and dz * xhat are
    all-reduced before bwd2, so dx is the gradient of every rank's loss,
    as the unfused ``BatchNorm``'s ``all_reduce_sum`` gives it; the
    gradients of scale, bias and alpha stay this rank's, as the unfused
    path's do, and the trainer's mean over ranks finishes them."""

    @staticmethod
    def forward(ctx, x, scale, bias, alpha, eps):
        out, mean, var, rstd, count = _train_forward(x, scale, bias, alpha,
                                                     eps)
        ctx.save_for_backward(x, scale, bias, alpha, mean, rstd)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, scale, bias, alpha, mean, rstd = ctx.saved_tensors
        dout = dout.to(x.dtype)
        if x.device.type == "cpu":
            dz, dgamma, dbeta, dalpha = bn_prelu_pool_bwd1_plain(
                x, scale, bias, alpha, mean, rstd, dout)
        else:
            dz, red = bn_prelu_pool_bwd1(
                x, _pack(mean, rstd, scale, bias, alpha),
                dout.contiguous(memory_format=CL))
            dbeta, dgamma, dalpha = red[0], red[1], red[2]
        (g_beta, g_gamma), _ = _global_sums([dbeta, dgamma])
        m = ctx.count
        if x.device.type == "cpu":
            dx = bn_prelu_pool_bwd2_plain(x, scale, mean, rstd, dz, g_gamma,
                                          g_beta, count=m)
        else:
            p2 = _pack(mean, rstd, scale.float() * rstd, g_beta / m,
                       g_gamma / m)
            dx = bn_prelu_pool_bwd2(x, p2, dz)
        return (dx, dgamma.to(scale.dtype), dbeta.to(bias.dtype),
                dalpha.to(alpha.dtype), None)


def bn_prelu_pool(x, scale, bias, alpha, *, eps: float = 1e-5, train: bool,
                  running_mean=None, running_var=None):
    """Fused BN + PReLU + 3x3/s2/p1 max-pool over (N, C, H, W).

    train=True: normalises with the batch statistics and returns (pooled,
    batch_mean, batch_var), differentiable in x, scale, bias and alpha.
    train=False: normalises with running_mean / running_var and returns the
    pooled output (not differentiable; the serving path). On the card an x
    that is not channels-last is copied to that layout first (the stem's
    own x already is); the output is channels-last."""
    if x.device.type == "cuda":
        x = x.contiguous(memory_format=CL)
    if train:
        _check(x, scale, bias, alpha)
        return BnPreluPoolFn.apply(x, scale, bias, alpha, eps)
    _check(x, scale, bias, alpha, running_mean, running_var)
    if x.device.type == "cpu":
        return bn_prelu_pool_plain(x, scale, bias, alpha, eps=eps,
                                   train=False, running_mean=running_mean,
                                   running_var=running_var)
    rstd = torch.rsqrt(running_var.float() + eps)
    return bn_prelu_pool_apply(x, _pack(running_mean, rstd, scale, bias,
                                        alpha))
