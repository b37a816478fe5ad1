"""Scattered-row gather: out[i] = src[idx[i]].

Counterpart of ``avsr_tpu/ops/pallas/row_gather.py`` ``row_gather``: each
decode step, the CTC prefix scorer's B*K*S' candidate rows of the
transposed (B*V, Tp) log-prob table. ``row_gather`` dispatches on the
tensor's device: on the CPU it runs ``row_gather_plain``, on a CUDA device
it launches ``csrc/row_gather.cu``. The result is exact either way (bytes
are copied). The beam itself gathers these rows in its pre-beam top-k's
launch (``topk.topk_gather_rows``), which saves this launch and the index
add before it; ``row_gather`` stays for any other gather of rows.

The TPU kernel copies the 8-row block around each row and selects the row
with a one-hot contraction, a workaround for the TPU's (8, 128) tiling
(hence its ``C % 128`` and ``R % 8`` checks). None of that carries over: a
CUDA block reads any row.
"""

from __future__ import annotations

import ctypes

import torch

from avsr_tpu_torch.ops.kernels import _build


def row_gather_plain(src, idx):
    return src.index_select(0, idx)


def _launch(src, idx):
    r, c = src.shape
    if src.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {src.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    fn = _build.function(
        "avsr_row_gather",
        (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,),
    )
    out = torch.empty((idx.shape[0], c), dtype=src.dtype, device=src.device)
    err = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), r, c,
             idx.shape[0], torch.cuda.current_stream(src.device).cuda_stream)
    _build.check("row_gather", err)
    row_gather.launches += 1
    return out


def row_gather(src, idx):
    """Rows ``idx`` (N,) int64 of a contiguous 2-D fp32 ``src`` (R, C), as
    a new (N, C) tensor. On the card an index outside [0, R) gives a row of
    NaN (the kernel does not fault); on the CPU it raises."""
    if src.dtype != torch.float32:
        raise TypeError(f"row_gather takes fp32 rows, got {src.dtype}")
    if idx.dtype != torch.int64:
        raise TypeError(f"row_gather takes int64 indices, got {idx.dtype}")
    if src.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"src (R, C) and idx (N,), got {tuple(src.shape)} "
                         f"and {tuple(idx.shape)}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if idx.device != src.device:
        raise ValueError(f"src on {src.device}, idx on {idx.device}")
    if src.device.type == "cpu":
        return row_gather_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"no row_gather for device {src.device}")
    if idx.numel() == 0:
        raise ValueError("row_gather of no rows")
    return _launch(src, idx)


row_gather.launches = 0
