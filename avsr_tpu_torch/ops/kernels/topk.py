"""Exact top-k over the last axis (descending, lower-index ties).

Counterpart of ``avsr_tpu/ops/pallas/topk.py`` ``topk_lastdim``, for any
k up to the row's length. ``topk_lastdim`` dispatches on the tensor's
device: on the CPU it runs ``topk_plain``, on a CUDA device it launches
``csrc/topk.cu``. For k up to ``MAX_K``: rows longer than
``WARP_ROW_MAX`` (the beam's vocabulary rows) a block a row, shorter ones
(its flat (B, K*(S'+1)) top-k) a warp a row. Beyond ``MAX_K`` (the
pre-beam of a beam of 22 or more): a block a row, a radix select over the
row staged in shared memory, for rows whose ``wide_smem_bytes`` fit
``WIDE_SMEM_MAX``.
``launches`` counts all three, ``flat_launches`` the warp-a-row kernel's
and ``wide_launches`` the k > ``MAX_K`` kernel's. torch.topk is not used:
its tie order on CUDA is not documented.
"""

from __future__ import annotations

import ctypes

import torch

from avsr_tpu_torch.ops.kernels import _build

MAX_K = 32  # csrc/topk.cu kMaxK: the largest k of the per-thread lists
WARP_ROW_MAX = 1024  # csrc/topk.cu kWarpRowMax
WIDE_SMEM_MAX = 230400  # csrc/topk.cu kWideSmemMax


def wide_smem_bytes(v: int, k: int) -> int:
    """The k > MAX_K kernel's dynamic shared memory (csrc/topk.cu
    ``wide_smem_bytes``): the row's keys, 8-byte aligned, and a sort buffer
    of next_pow2(k) 64-bit entries."""
    return (v + 1) // 2 * 8 + 8 * (1 << (k - 1).bit_length())


def topk_plain(x, k: int):
    """k rounds of (max, lowest index holding it, mask it to -inf)."""
    iota = torch.arange(x.shape[-1], device=x.device)
    vals, ids = [], []
    cur = x
    for _ in range(k):
        m = cur.amax(dim=-1, keepdim=True)
        idx = torch.where(cur == m, iota, x.shape[-1]).amin(dim=-1)
        vals.append(m[..., 0])
        ids.append(idx)
        cur = torch.where(iota == idx[..., None], float("-inf"), cur)
    return torch.stack(vals, -1), torch.stack(ids, -1)


def _launch(x2, k):
    rows, v = x2.shape
    if x2.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {x2.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if k > MAX_K and wide_smem_bytes(v, k) > WIDE_SMEM_MAX:
        raise ValueError(f"topk_lastdim at k={k} > {MAX_K} takes rows whose "
                         f"keys and sort buffer fit {WIDE_SMEM_MAX} bytes: "
                         f"v={v} needs {wide_smem_bytes(v, k)}")
    fn = _build.function(
        "avsr_topk_lastdim",
        (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,),
    )
    vals = torch.empty((rows, k), dtype=x2.dtype, device=x2.device)
    ids = torch.empty((rows, k), dtype=torch.int64, device=x2.device)
    err = fn(x2.data_ptr(), vals.data_ptr(), ids.data_ptr(), rows, v, k,
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check("topk_lastdim", err)
    topk_lastdim.launches += 1
    topk_lastdim.flat_launches += k <= MAX_K and v <= WARP_ROW_MAX
    topk_lastdim.wide_launches += k > MAX_K
    return vals, ids


def topk_lastdim(x, k: int):
    """(values, indices) of the k largest entries along the last axis of an
    fp32 tensor, sorted descending, ties toward the lower index. Indices
    are int64 (torch's index dtype)."""
    if x.dtype != torch.float32:
        raise TypeError(f"topk_lastdim takes fp32, got {x.dtype}")
    if not 0 < k <= x.shape[-1]:
        raise ValueError(f"k={k} outside [1, {x.shape[-1]}]")
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    if x.device.type == "cpu":
        return topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"no topk_lastdim for device {x.device}")
    lead = x.shape[:-1]
    vals, ids = _launch(x.reshape(-1, x.shape[-1]), k)
    return vals.view(*lead, k), ids.view(*lead, k)


topk_lastdim.launches = 0
topk_lastdim.flat_launches = 0
topk_lastdim.wide_launches = 0
