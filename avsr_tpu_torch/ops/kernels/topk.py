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

``topk_gather_rows`` is the beam's pre-beam top-k with the CTC scorer's
candidate rows (``row_gather.row_gather`` of the transposed log-prob
table) copied in the same launch; its launches count in
``topk_lastdim``'s counters as well and in ``gather_launches``
(``topk_gather_rows.launches`` too).
"""

from __future__ import annotations

import ctypes

import torch

from avsr_tpu_torch.ops.kernels import _build
from avsr_tpu_torch.ops.kernels.row_gather import row_gather_plain

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


def _launch(x2, k, table=None, lanes=1):
    rows, v = x2.shape
    if x2.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {x2.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if k > MAX_K and wide_smem_bytes(v, k) > WIDE_SMEM_MAX:
        raise ValueError(f"topk_lastdim at k={k} > {MAX_K} takes rows whose "
                         f"keys and sort buffer fit {WIDE_SMEM_MAX} bytes: "
                         f"v={v} needs {wide_smem_bytes(v, k)}")
    vals = torch.empty((rows, k), dtype=x2.dtype, device=x2.device)
    ids = torch.empty((rows, k), dtype=torch.int64, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    if table is None:
        fn = _build.function(
            "avsr_topk_lastdim",
            (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,),
        )
        out = None
        err = fn(x2.data_ptr(), vals.data_ptr(), ids.data_ptr(), rows, v, k,
                 stream)
    else:
        fn = _build.function(
            "avsr_topk_gather_rows",
            (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
            + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 2
            + (ctypes.c_void_p,),
        )
        out = torch.empty((rows * k, table.shape[1]), dtype=table.dtype,
                          device=table.device)
        err = fn(x2.data_ptr(), vals.data_ptr(), ids.data_ptr(), rows, v, k,
                 table.data_ptr(), out.data_ptr(), lanes, table.shape[1],
                 stream)
    _build.check("topk_lastdim" if table is None else "topk_gather_rows", err)
    topk_lastdim.launches += 1
    topk_lastdim.flat_launches += k <= MAX_K and v <= WARP_ROW_MAX
    topk_lastdim.wide_launches += k > MAX_K
    if table is not None:
        topk_lastdim.gather_launches += 1
        topk_gather_rows.launches += 1
    return vals, ids, out


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
    vals, ids, _ = _launch(x.reshape(-1, x.shape[-1]), k)
    return vals.view(*lead, k), ids.view(*lead, k)


def topk_gather_rows(x, k: int, table):
    """``topk_lastdim(x, k)`` of an fp32 x (B, K, V), and the rows of
    ``table`` (B*V, Tp) fp32 that its ids pick: rows[(b*K + j)*k + q] =
    table[b*V + ids[b, j, q]], a new (B*K*k, Tp) tensor. Returns (values,
    ids, rows). One launch on the card (an id outside [0, V), which only
    a row of NaN gives there, takes a row of NaN); on the CPU
    ``topk_plain`` then ``row_gather_plain``."""
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"topk_gather_rows takes fp32, got {x.dtype} and "
                        f"{table.dtype}")
    if x.dim() != 3 or table.dim() != 2:
        raise ValueError(f"x (B, K, V) and table (B*V, Tp), got "
                         f"{tuple(x.shape)} and {tuple(table.shape)}")
    b, lanes, v = x.shape
    if table.shape[0] != b * v:
        raise ValueError(f"table has {table.shape[0]} rows, x asks for "
                         f"B*V = {b * v}")
    if not 0 < k <= v:
        raise ValueError(f"k={k} outside [1, {v}]")
    if not (x.is_contiguous() and table.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if table.device != x.device:
        raise ValueError(f"x on {x.device}, table on {table.device}")
    if x.device.type == "cpu":
        vals, ids = topk_plain(x, k)
        base = torch.arange(b, device=x.device)[:, None, None] * v
        return vals, ids, row_gather_plain(table, (ids + base).view(-1))
    if x.device.type != "cuda":
        raise ValueError(f"no topk_gather_rows for device {x.device}")
    vals, ids, rows = _launch(x.view(b * lanes, v), k, table, lanes)
    return vals.view(b, lanes, k), ids.view(b, lanes, k), rows


topk_lastdim.launches = 0
topk_lastdim.flat_launches = 0
topk_lastdim.wide_launches = 0
topk_lastdim.gather_launches = 0
topk_gather_rows.launches = 0
