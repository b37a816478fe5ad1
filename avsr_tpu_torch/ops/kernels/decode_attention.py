"""Decode-step self-attention with lazy beam reorder and in-kernel row write.

Counterpart of ``avsr_tpu/ops/pallas/decode_attention.py``
(``decode_attention`` with ``kv_row``, resident v3). ``decode_attention``
dispatches on the tensors' device: on the CPU it runs
``decode_attention_plain``, on a CUDA device it launches
``csrc/decode_attention.cu`` over thread-block clusters, with the launch
plan (``launch_plan``: cluster size, rows a rank, tile, shared memory)
computed here. Beyond ``MAX_LANES`` beam lanes (beams of 9 and more) it
launches the source's block-a-query kernel instead (no plan);
``wide_launches`` counts those launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.kernels import _build

# the kernel's launch: 128 threads (4 warps) a block, clusters of a portable
# size (at most 8 blocks), one stage buffer of at most STAGE_BYTES, and the
# opt-in shared-memory limit of a block on the H100 (227 KB)
THREADS = 128
WARPS = THREADS // 32
CLUSTER_SIZES = (2, 4, 8)
# G=2: the fastest of G = 1, 2, 4, 8 at B=8 and at B=32 (H=16), the two
# batches measured (tools/decode_variants.py on the H100)
CLUSTER = 2
STAGE_BYTES = 48 * 1024
SMEM_MAX = 232448
MAX_LANES = 8  # csrc/decode_attention.cu kMaxLanes


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


def _ulp(x, dtype):
    """One unit in the last place of dtype at |x| (0 at 0): 2^(e - t + 1)
    for |x| in [2^e, 2^(e + 1)), t the dtype's significand bits."""
    bits = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}[dtype]
    x = x.abs()
    e = torch.floor(torch.log2(torch.where(x > 0, x, torch.ones_like(x))))
    return torch.where(x > 0, torch.exp2(e - (bits - 1)), torch.zeros_like(x))


def output_bound(pos: int, q, kv_cache, lane_bias, lanes: int, heads: int,
                 kv_row):
    """Per output element (N, C), how far two fp32 evaluations of
    ``decode_attention`` may lie apart with the TPU kernel's rounding
    points, whatever the order of their sums (ROADMAP C27).

    Each normalised p is rounded to the cache dtype: the two evaluations'
    fp32 p differ by a few fp32 ulps (the max is exact; the denominator and
    q.k are sums in other orders), so a p at a rounding boundary may round
    either way, by one ulp of the cache dtype at p. The P.V sums then
    differ by at most sum_r ulp(p_r) |v_r| plus their own fp32 rounding,
    2 gamma_n sum_r p_r |v_r| (gamma_n = n u / (1 - n u), u = 2^-24, n the
    rows); the output's rounding to q's dtype adds one ulp of that dtype
    at |out| (for fp32 q, an fp32 ulp). p and out are the twin's."""
    n, s_max, c2 = kv_cache.shape
    c = c2 // 2
    b = n // lanes
    dh = c // heads
    cd = kv_cache.dtype
    kv = kv_cache.clone()
    kv[:, min(pos, s_max - 1)] = kv_row.to(cd)
    kv = kv.view(b, lanes, s_max, 2, heads, dh).float()
    qq = q.to(cd).float().view(b, lanes, heads, dh)
    scores = torch.einsum("bkhd,bjshd->bhkjs", qq, kv[:, :, :, 0])
    scores = scores + lane_bias.float().permute(0, 1, 3, 2)[:, None]
    flat = scores.reshape(b, heads, lanes, lanes * s_max)
    p = torch.exp(flat - flat.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(cd).float()
    v = kv[:, :, :, 1].permute(0, 3, 1, 2, 4).reshape(b, heads,
                                                        lanes * s_max, dh)
    rows = lanes * s_max
    gamma = rows * 2.0 ** -24 / (1 - rows * 2.0 ** -24)
    out = torch.einsum("bhkr,bhrd->bhkd", p, v)
    delta = (torch.einsum("bhkr,bhrd->bhkd", _ulp(p, cd), v.abs())
             + 2 * gamma * torch.einsum("bhkr,bhrd->bhkd", p, v.abs()))
    delta = delta + _ulp(out.abs() + delta, q.dtype)
    return delta.permute(0, 2, 1, 3).reshape(n, c)


class Plan(NamedTuple):
    """A launch of the kernel: ``cluster`` blocks share one (utterance,
    head); rank r takes rows [r * rows_per_rank, (r + 1) * rows_per_rank)
    of the ``rows`` = lanes * (min(pos, S-1) + 1) (j, s) rows of the
    prefix, in tiles of ``tile`` rows (two stage buffers), with ``smem``
    bytes of dynamic shared memory."""
    cluster: int
    rows_per_rank: int
    tile: int
    smem: int
    grid: tuple
    rows: int

    def rank_rows(self, rank: int) -> range:
        begin = min(rank * self.rows_per_rank, self.rows)
        return range(begin, min(begin + self.rows_per_rank, self.rows))


def smem_bytes(lanes: int, dh: int, esize: int, rows_per_rank: int,
               tile: int) -> int:
    """Shared memory of one block (``smem_bytes`` of the CUDA source): two
    stage buffers of ``tile`` rows rounded up to 16, a row dh cache
    elements and a 16-byte pad; fp32 scores (lanes, rows_per_rank); the
    local and the joint (m, l) per query; the warps' partial outputs and
    the rank's (lanes, dh)."""
    return (2 * -(-tile // 16) * 16 * (dh * esize + 16)
            + 4 * (lanes * rows_per_rank + 4 * lanes
                   + (WARPS + 1) * lanes * dh))


@functools.lru_cache(maxsize=4096)
def launch_plan(b: int, lanes: int, heads: int, dh: int, s_max: int,
                pos: int, esize: int, cluster: int | None = None) -> Plan:
    """The kernel's launch for one step. ``cluster`` forces G (1, 2, 4 or
    8; the variants tool sweeps it); by default CLUSTER, raised while the
    scores of a rank's rows overflow shared memory. The tile is the whole
    chunk where it fits STAGE_BYTES. Raises ValueError where no plan
    fits."""
    rows = lanes * (min(pos, s_max - 1) + 1)
    row_bytes = dh * esize
    sizes = (cluster,) if cluster else tuple(
        g for g in CLUSTER_SIZES if g >= CLUSTER)
    for g in sizes:
        rpr = -(-rows // g)
        fixed = smem_bytes(lanes, dh, esize, rpr, 0)
        # whole 16-row groups of padded rows in the two stage buffers
        room = (SMEM_MAX - fixed) // (2 * (row_bytes + 16)) // 16 * 16
        tile = min(rpr, max(16, STAGE_BYTES // row_bytes // 16 * 16), room)
        if tile >= 1:
            return Plan(g, rpr, tile,
                        smem_bytes(lanes, dh, esize, rpr, tile),
                        (heads * g, b), rows)
    raise ValueError(f"no launch of decode_attention fits {SMEM_MAX} bytes "
                     f"of shared memory: lanes={lanes}, dh={dh}, "
                     f"s_max={s_max}, pos={pos}, cluster={cluster}")


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


def _launch_wide(pos, q, kv_cache, lane_bias, lanes, heads, kv_row):
    n, s_max, c2 = kv_cache.shape
    fn = _build.function(
        "avsr_decode_attention_wide",
        (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,),
    )
    kv_row = kv_row.to(kv_cache.dtype)
    if kv_row.data_ptr() % 16:  # the kernel reads it 16 bytes at a time
        kv_row = kv_row.clone()
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), kv_cache.data_ptr(), lane_bias.data_ptr(),
             kv_row.data_ptr(), out.data_ptr(), n // lanes, lanes, heads,
             c2 // 2 // heads, s_max, int(pos), _build.dtype_code(q.dtype),
             _build.dtype_code(kv_cache.dtype),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err)
    decode_attention.launches += 1
    decode_attention.wide_launches += 1
    return out, kv_cache


def _launch(pos, q, kv_cache, lane_bias, lanes, heads, kv_row,
            cluster=None):
    n, s_max, c2 = kv_cache.shape
    dh = c2 // 2 // heads
    esize = kv_cache.element_size()
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if dh * esize % 16 or dh * esize > 512:
        raise ValueError(f"kernel takes head dims of 1-32 16-byte chunks, "
                         f"got dh={dh}")
    if kv_cache.data_ptr() % 16:
        raise ValueError("kv_cache must be 16-byte aligned")
    if lanes > MAX_LANES:
        return _launch_wide(pos, q, kv_cache, lane_bias, lanes, heads, kv_row)
    plan = launch_plan(n // lanes, lanes, heads, dh, s_max, int(pos), esize,
                       cluster)
    fn = _build.function(
        "avsr_decode_attention",
        (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 12 + (ctypes.c_void_p,),
    )
    kv_row = kv_row.to(kv_cache.dtype)
    if kv_row.data_ptr() % 16:  # the kernel copies it 16 bytes at a time
        kv_row = kv_row.clone()
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), kv_cache.data_ptr(), lane_bias.data_ptr(),
             kv_row.data_ptr(), out.data_ptr(), n // lanes, lanes, heads, dh,
             s_max, int(pos), _build.dtype_code(q.dtype),
             _build.dtype_code(kv_cache.dtype), plan.cluster,
             plan.rows_per_rank, plan.tile, plan.smem,
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
        warm_exp()
        return decode_attention_plain(pos, q, kv_cache, lane_bias, lanes,
                                      heads, kv_row)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {q.device}")
    return _launch(pos, q, kv_cache, lane_bias, lanes, heads, kv_row)


decode_attention.launches = 0
decode_attention.wide_launches = 0
