"""Inclusive cumulative logsumexp down the leading axis.

Counterpart of ``avsr_tpu/ops/pallas/scan_logsumexp.py`` ``cumlogsumexp``:
the CTC prefix scorer's two scans per decode step. ``cumlogsumexp``
dispatches on the tensor's device: on the CPU it runs
``cumlogsumexp_plain``, on a CUDA device it launches
``csrc/scan_logsumexp.cu``, a parallel scan: a warp a column, LANE_ROWS
consecutive rows a lane, a Kogge-Stone over the 32 lanes' totals, and a
carry from one chunk of CHUNK_ROWS rows to the next.

Both keep every prefix shifted by its own running maximum. A column-global
maximum with one cumulative sum is not equivalent: the CTC terms drift by
about |log p| a frame, so at T=375 the early prefixes sit more than 87 nats
below the column maximum and underflow.
"""

from __future__ import annotations

import ctypes

import torch

from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.kernels import _build

NEG_INF = float("-inf")
# the kernel's scan shape (kLaneRows of csrc/scan_logsumexp.cu)
LANE_ROWS = 12
CHUNK_ROWS = 32 * LANE_ROWS


def cumlogsumexp_plain(x):
    """The TPU kernel's Kogge-Stone recursion over (running max m, shifted
    sum s) pairs along axis 0 of a (T, ...) fp32 tensor, with its guard
    (``max(mm, -3.0e38)``, so that -inf - -inf never occurs) and its output
    ``log(max(s, 1e-37)) + m``: an all -inf prefix gives -inf."""
    t = x.shape[0]
    m = x
    s = torch.ones_like(x)
    d = 1
    while d < t:
        sm = torch.cat([m.new_full((d, *m.shape[1:]), NEG_INF), m[: t - d]])
        ss = torch.cat([s.new_zeros((d, *s.shape[1:])), s[: t - d]])
        mm = torch.maximum(m, sm)
        safe = mm.clamp_min(-3.0e38)
        s = s * torch.exp(m - safe) + ss * torch.exp(sm - safe)
        m = mm
        d *= 2
    return torch.log(s.clamp_min(1e-37)) + m


def _launch(x2):
    t, c = x2.shape
    if x2.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {x2.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    fn = _build.function(
        "avsr_cumlogsumexp",
        (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 2 + (ctypes.c_void_p,),
    )
    out = torch.empty_like(x2)
    err = fn(x2.data_ptr(), out.data_ptr(), t, c,
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check("cumlogsumexp", err)
    cumlogsumexp.launches += 1
    return out


def cumlogsumexp(x):
    """Inclusive cumulative logsumexp over axis 0 of a contiguous (T, ...)
    fp32 tensor; the trailing axes are independent columns."""
    if x.dtype != torch.float32:
        raise TypeError(f"cumlogsumexp takes fp32, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"cumlogsumexp of an empty tensor {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    if x.device.type == "cpu":
        warm_exp()
        return cumlogsumexp_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no cumlogsumexp for device {x.device}")
    return _launch(x.reshape(x.shape[0], -1)).view(x.shape)


cumlogsumexp.launches = 0
