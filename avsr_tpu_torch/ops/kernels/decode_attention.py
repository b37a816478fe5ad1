"""Decode-step self-attention with lazy beam reorder and in-kernel row write.

Counterpart of ``avsr_tpu/ops/pallas/decode_attention.py``
(``decode_attention`` with ``kv_row``, resident v3). ``decode_attention``
dispatches on the tensors' device: on the CPU it runs
``decode_attention_plain``, on a CUDA device it launches
``csrc/decode_attention.cu`` over thread-block clusters, with the launch
plan (``launch_plan``: cluster size, rows a rank, tile, shared memory)
computed here. The step ``pos`` is read on the device, as the TPU kernel
reads it from SMEM (so a launch captured in a CUDA graph reads each
replay's step): the plan is fixed at the cache's S rows and the kernel
splits the step's live rows over the cluster itself. One launch reads
each (utterance, head)'s prefix once for
up to ``GROUP_LANES`` beam lanes (their queries as up to eight 8-lane mma
operands); ``wide_launches`` counts the launches beyond ``MAX_LANES``
lanes (one operand tile: beams of 9 and more), ``tf32_launches`` those
of an fp32 cache with ``MMA_DH``-wide heads, whose q.k and P.V run in
split TF32 on the tensor cores.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.kernels import _build

# the kernel's launch: 256 threads (8 warps) a block, clusters of a portable
# size (at most 8 blocks), one stage buffer of at most STAGE_BYTES, and the
# opt-in shared-memory limit of a block on the H100 (227 KB)
THREADS = 256
WARPS = THREADS // 32
CLUSTER_SIZES = (2, 4, 8)
# G=2: the fastest of G = 1, 2, 4, 8 at B=8 (H=16) for one query tile; at
# B=32 G=1 is with a bf16 cache (tools/decode_variants.py on the H100):
# where the (utterance, head) pairs fill the card's SMS SMs twice over, one
# block a pair. An fp32 cache's rows, twice as long, keep G=2 there (split
# TF32 at C=768, B=32: 0.0707 ms cold against G=1's 0.0756)
CLUSTER = 2
SMS = 132  # the H100's SMs
STAGE_BYTES = 48 * 1024
SMEM_MAX = 232448
# two blocks an SM: each with its 1 KB reserve within the SM's 228 KB
PAIR_SMEM = 113 * 1024
PAIR_TILE = 64  # the least tile of a two-blocks-an-SM plan
TWO_PASS_TILE = 128  # the tile of a two-pass plan
MAX_LANES = 8  # csrc/decode_attention.cu kTileLanes: one mma query tile
GROUP_LANES = 64  # csrc/decode_attention.cu kGroupLanes: a block's queries
MMA_DH = 64  # csrc/decode_attention.cu kMmaDh: the heads whose products use mma


def _row(pos, kv_cache):
    """The written row min(pos, S-1) as a (1,) int64 tensor on the cache's
    device; ``pos`` an int or a one-element tensor, not read on the host."""
    return _build.device_step(pos, kv_cache.device).long().clamp_max(
        kv_cache.shape[1] - 1)


def decode_attention_plain(pos, q, kv_cache, lane_bias, lanes: int,
                           heads: int, kv_row):
    """Plain torch twin. Writes ``kv_row`` into row min(pos, S-1) of
    ``kv_cache`` in place, then attends with the TPU kernel's rounding
    points: q and the normalised probabilities are cast to the cache dtype
    before their products, which accumulate in fp32."""
    n, s_max, c2 = kv_cache.shape
    c = c2 // 2
    b = n // lanes
    dh = c // heads
    kv_cache.index_copy_(1, _row(pos, kv_cache),
                         kv_row.to(kv_cache.dtype)[:, None])
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


def output_bound(pos, q, kv_cache, lane_bias, lanes: int, heads: int,
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
    kv.index_copy_(1, _row(pos, kv), kv_row.to(cd)[:, None])
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
    (a multiple of 4) of the ``rows`` rows of the prefix, row r = s *
    lanes + j (position s of stored lane j), in tiles of ``tile`` rows
    (two stage buffers), holding the scores of ``chunk`` rows at once: one
    pass where ``chunk`` is ``rows_per_rank``, else two over chunks of
    whole tiles, the second taking the scores again; query groups of
    ``group_lanes`` lanes, ``groups`` of them (the grid's third axis),
    each reading the prefix once; ``smem`` bytes of dynamic shared memory.
    ``launch_plan`` sizes it for all ``lanes`` * S rows; the kernel reads
    the step on the device and splits its live rows as ``at(pos)`` does."""
    cluster: int
    rows_per_rank: int
    tile: int
    smem: int
    grid: tuple
    rows: int
    chunk: int
    group_lanes: int
    groups: int
    lanes: int = 0
    s_max: int = 0

    def at(self, pos: int) -> "Plan":
        """The launch as the kernel runs step ``pos``: the prefix's
        lanes * (min(pos, S-1) + 1) live rows, rank r taking
        ceil(rows / 4G) * 4 of them (each rank's bias 16-byte aligned),
        with the launch's tile, chunk and shared memory."""
        rows = self.lanes * (min(pos, self.s_max - 1) + 1)
        return self._replace(rows=rows, rows_per_rank=-(-rows // (
            4 * self.cluster)) * 4)

    def rank_rows(self, rank: int) -> range:
        begin = min(rank * self.rows_per_rank, self.rows)
        return range(begin, min(begin + self.rows_per_rank, self.rows))

    def rank_chunks(self, rank: int) -> list:
        """The rank's rows in the chunks whose scores it holds at once."""
        rows = self.rank_rows(rank)
        return [range(r, min(r + self.chunk, rows.stop))
                for r in range(rows.start, rows.stop, self.chunk)]


def query_words(lanes: int, dh: int, esize: int) -> int:
    """32-bit words of the queries in a block's shared memory
    (``query_words`` of the CUDA source): (lanes, dh) fp32 values, or with
    an fp32 cache and MMA_DH-wide heads (split TF32) the hi and lo B
    fragments of whole 8-query tiles."""
    if esize == 4 and dh == MMA_DH:
        return 2 * -(-lanes // MAX_LANES) * MAX_LANES * dh
    return lanes * dh


def smem_bytes(lanes: int, dh: int, esize: int, chunk: int,
               tile: int) -> int:
    """Shared memory of one block (``smem_bytes`` of the CUDA source): two
    stage buffers of ``tile`` rows rounded up to 16, a row dh cache
    elements and a 16-byte pad; fp32 scores (lanes, chunk), rounded up to
    4 floats; the local and the joint (m, l) per query; the queries
    (``query_words``) and the rank's partial outputs (lanes, dh).
    ``lanes``: a query group's."""
    return (2 * -(-tile // 16) * 16 * (dh * esize + 16)
            + 4 * (-(-lanes * chunk // 4) * 4 + 4 * lanes
                   + query_words(lanes, dh, esize) + lanes * dh))


def _tiles(budget: int, lanes: int, dh: int, esize: int, rpr: int,
           least: int):
    """(tile, chunk = rpr) of the largest tile (the rank's rows where they
    fit STAGE_BYTES, else a multiple of 16 rows, at least ``least``) whose
    one-pass layout (the scores of all the rank's rows) fits ``budget``
    bytes; None where none does."""
    most = min(rpr, max(16, STAGE_BYTES // (dh * esize) // 16 * 16))
    for tile in [most] + list(range(most // 16 * 16, least - 1, -16)):
        if 1 <= tile and smem_bytes(lanes, dh, esize, rpr, tile) <= budget:
            return tile, rpr
    return None


@functools.lru_cache(maxsize=1024)
def launch_plan(b: int, lanes: int, heads: int, dh: int, s_max: int,
                esize: int, cluster: int | None = None) -> Plan:
    """The kernel's launch for every step over an S = ``s_max``-row cache:
    sized for its lanes * S rows, whatever the step (the kernel splits a
    step's live rows itself, ``Plan.at``). Lanes beyond GROUP_LANES split
    into even query groups. ``cluster`` forces G (1, 2, 4 or 8; the
    variants tool sweeps it); by default CLUSTER (1 for one query tile of
    a bf16 cache where B*H pairs fill the card twice), raised while a
    rank's scores would not fit one pass. A one-pass layout within
    PAIR_SMEM (two blocks an SM, a tile of at least PAIR_TILE rows) at the
    least G that gives one comes first (at 22 lanes over a 192-row cache
    G=8 two an SM measured 0.18 ms at B=8 against G=2's 0.27 one an SM),
    else within SMEM_MAX; where no G gives one, the largest G's rank holds
    the scores of a chunk of its rows at a time and takes them twice.
    Raises ValueError where no plan fits."""
    rows = lanes * s_max
    groups = -(-lanes // GROUP_LANES)
    gl = -(-lanes // groups)
    least = (1 if esize == 2 and lanes <= MAX_LANES and b * heads >= 2 * SMS
             else CLUSTER)
    sizes = (cluster,) if cluster else tuple(
        g for g in (1, *CLUSTER_SIZES) if g >= least)

    def rank_rows(g):  # a multiple of 4: each rank's bias 16-byte aligned
        return -(-rows // (4 * g)) * 4

    def plan(g, tile, chunk):
        rpr = rank_rows(g)
        return Plan(g, rpr, tile, smem_bytes(gl, dh, esize, chunk, tile),
                    (heads * g, b), rows, chunk, gl, groups, lanes, s_max)

    for budget, pair in ((PAIR_SMEM, True), (SMEM_MAX, False)):
        for g in sizes:
            rpr = rank_rows(g)
            got = _tiles(budget, gl, dh, esize, rpr,
                         min(PAIR_TILE, rpr) if pair else 1)
            if got:
                return plan(g, *got)
    # two passes: tiles of up to TWO_PASS_TILE rows, the most whole tiles
    # of scores that fit beside them
    g = sizes[-1]
    rpr = rank_rows(g)
    for tile in range(min(TWO_PASS_TILE, rpr), 0, -16):
        room = SMEM_MAX - smem_bytes(gl, dh, esize, 0, tile)
        chunk = room // (4 * gl) // tile * tile
        if chunk >= tile:
            return plan(g, tile, chunk)
    raise ValueError(f"no launch of decode_attention fits {SMEM_MAX} bytes "
                     f"of shared memory: lanes={lanes}, dh={dh}, "
                     f"s_max={s_max}, cluster={cluster}")


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
    devs = {x.device for x in (q, kv_cache, lane_bias, kv_row)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {devs}")
    for x in (q, kv_cache, lane_bias, kv_row):
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")


def _launch(pos, q, kv_cache, lane_bias, lanes, heads, kv_row,
            cluster=None, plan=None, cuda_cores=False):
    """Launches the kernel; ``cluster`` forces G, ``plan`` the whole launch.
    ``cuda_cores`` takes the CUDA-core instance even where the heads are
    MMA_DH wide (the yardstick of the tensor-core instances; the decoder
    never sets it)."""
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
    if plan is None:
        plan = launch_plan(n // lanes, lanes, heads, dh, s_max, esize,
                           cluster)
    step = _build.device_step(pos, q.device)
    fn = _build.function(
        "avsr_decode_attention",
        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 14 + (ctypes.c_void_p,),
    )
    kv_row = kv_row.to(kv_cache.dtype)
    if kv_row.data_ptr() % 16:  # the kernel copies it 16 bytes at a time
        kv_row = kv_row.clone()
    if q.data_ptr() % 16:  # the mma path reads q 16 bytes at a time
        q = q.clone()
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), kv_cache.data_ptr(), lane_bias.data_ptr(),
             kv_row.data_ptr(), out.data_ptr(), step.data_ptr(), n // lanes,
             lanes, heads, dh, s_max, _build.dtype_code(q.dtype),
             _build.dtype_code(kv_cache.dtype), plan.cluster,
             plan.rows_per_rank, plan.tile, plan.chunk, plan.group_lanes,
             plan.smem, int(cuda_cores),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err)
    decode_attention.launches += 1
    decode_attention.wide_launches += lanes > MAX_LANES
    decode_attention.tf32_launches += (esize == 4 and dh == MMA_DH
                                       and not cuda_cores)
    return out, kv_cache


def decode_attention(pos, q, kv_cache, lane_bias, lanes: int,
                     heads: int, kv_row):
    """One decode step's self-attention for all N = B*lanes beam lanes.

    pos: the step's position, a one-element int32 or int64 tensor on the
    inputs' device (the kernel reads it there; the wrapper does not) or an
    int (made into one); q (N, C) queries pre-scaled by
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
decode_attention.tf32_launches = 0
