"""One decoder layer's decode step in one kernel launch.

Counterpart of ``avsr_tpu/ops/pallas/decoder_layer.py``
(``pack_layer_params``, ``decoder_layer_step``): LN1 + QKV, self-attention
with lazy beam reorder and the step's fresh K|V row, out-projection,
LN2 + cross-attention over the shared source K/V, LN3 + ReLU FFN, each with
its residual. ``decoder_layer_step`` dispatches on the device: CPU tensors
run ``decoder_layer_step_plain``, CUDA tensors launch the cooperative kernel
of ``csrc/decoder_layer.cu`` once, at any batch, for up to ``MAX_LANES``
beam lanes an utterance. Its launch plan is here
(``launch_plan``): the items of each of the six GEMVs (rows a multiple of
8, and K slices: split-K) over the grid, so that the blocks share every
GEMV phase. The kernel's layout (a block's shared memory, the grid of
every block the card holds at once, the most rows of an item) is the CUDA
source's, which the plan asks for on the card (``card_plan``).

The rounding points are the TPU kernel's, not the port's unfused step:
the residual stream is fp32 inside the layer and rounded to the parameter
dtype once at the end; every product against a weight takes its operand
rounded to the weight dtype and returns fp32 with the bias added; q is
scaled in fp32, rounded to the weight dtype and then to the cache dtype;
probabilities are normalised in fp32 (denominator clamped at 1e-30) and
rounded to the cache dtype before P.V.

The step's own K|V row enters the self-attention from the QKV product. While
pos < S the stale cache row at pos is masked; at pos >= S (a capped cache)
all S stored rows are attended, the stale row S-1 included, plus the fresh
row. The fresh row is then written at min(pos, S-1), in place. The step
pos is read on the device, as the TPU kernel reads it from SMEM, so a
launch captured in a CUDA graph reads each replay's step.

SELFCHECK-EXEMPT: opt-in path (``cfg.decode_fused_layer``, default off),
as the JAX package's ``decoder_layer.py`` is exempt from its self-check;
``chip_smoke.py`` phase 3 holds the kernel against its twin at the
serving widths.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.kernels import _build

NEG_INF = -1.0e30
LN_EPS = 1e-12
MAX_LANES = 32  # csrc/decoder_layer.cu kMaxLanes: beam lanes an utterance


class PackedLayer(NamedTuple):
    """One decoder layer's weights in the parameter dtype; matrices (out,
    in) as ``nn.Linear`` keeps them."""

    ln_w: torch.Tensor  # (3, C) norm1..3 scales
    ln_b: torch.Tensor  # (3, C)
    w_qkv: torch.Tensor  # (3C, C) linear_q | linear_k | linear_v
    b_qkv: torch.Tensor  # (3C,)
    w_out: torch.Tensor  # (C, C) self_attn.linear_out
    b_out: torch.Tensor
    w_q2: torch.Tensor  # (C, C) src_attn.linear_q
    b_q2: torch.Tensor
    w_out2: torch.Tensor  # (C, C) src_attn.linear_out
    b_out2: torch.Tensor
    w_1: torch.Tensor  # (F, C)
    b_1: torch.Tensor
    w_2: torch.Tensor  # (C, F)
    b_2: torch.Tensor


@torch.no_grad()
def pack_layer_params(layer, dtype) -> PackedLayer:
    """A ``DecoderLayer``'s weights, packed once at cache init."""
    sa, xa, ff = layer.self_attn, layer.src_attn, layer.feed_forward
    norms = (layer.norm1, layer.norm2, layer.norm3)
    parts = (
        torch.stack([m.weight for m in norms]),
        torch.stack([m.bias for m in norms]),
        torch.cat([sa.linear_q.weight, sa.linear_k.weight,
                   sa.linear_v.weight]),
        torch.cat([sa.linear_q.bias, sa.linear_k.bias, sa.linear_v.bias]),
        sa.linear_out.weight, sa.linear_out.bias,
        xa.linear_q.weight, xa.linear_q.bias,
        xa.linear_out.weight, xa.linear_out.bias,
        ff.w_1.weight, ff.w_1.bias, ff.w_2.weight, ff.w_2.bias,
    )
    return PackedLayer(*(t.detach().to(dtype).contiguous() for t in parts))


def decoder_layer_step_plain(pos, x, kv_cache, src_k, src_v, mem_bias,
                             lane_bias, packed: PackedLayer, lanes: int,
                             heads: int):
    """Plain torch twin (see the module docstring for its rounding points).
    Reads every stored row, as the TPU kernel does. ``pos``: an int or a
    one-element tensor on the inputs' device, not read on the host."""
    step = _build.device_step(pos, x.device).long()  # (1,)
    n, s_max, c2 = kv_cache.shape
    c = c2 // 2
    b = n // lanes
    dh = c // heads
    s_enc = src_k.shape[1]
    cd = torch.promote_types(x.dtype, torch.float32)
    wd, kd = packed.w_qkv.dtype, kv_cache.dtype
    p = [t.to(cd) for t in packed]
    (ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w_q2, b_q2, w_out2, b_out2,
     w_1, b_1, w_2, b_2) = p
    scale = float(torch.tensor(dh ** -0.5, dtype=torch.float32))

    def rnd(t, dt):
        return t.to(dt).to(cd)

    def dense(h, w, bias):
        return rnd(h, wd) @ w.T + bias

    def ln(v, i):
        m = v.mean(dim=-1, keepdim=True)
        cen = v - m
        var = (cen * cen).mean(dim=-1, keepdim=True)
        return cen * torch.rsqrt(var + LN_EPS) * ln_w[i] + ln_b[i]

    xf = x.to(cd)
    qkv = dense(ln(xf, 0), w_qkv, b_qkv)
    q = rnd(rnd(qkv[:, :c] * scale, wd), kd).view(b, lanes, heads, dh)
    k_new = rnd(qkv[:, c:2 * c], kd).view(b, lanes, heads, dh)
    v_new = rnd(qkv[:, 2 * c:], kd).view(b, lanes, heads, dh)
    kv = kv_cache.to(cd).view(b, lanes, s_max, 2, heads, dh)
    # scores over (stored lane j, row s); the stale row at pos < S masked
    scores = torch.einsum("bkhd,bjshd->bhkjs", q, kv[:, :, :, 0])
    scores = scores + lane_bias.to(cd).permute(0, 1, 3, 2)[:, None]
    stale = ((torch.arange(s_max, device=x.device) == step)
             & (step < s_max))  # (S,): the stale row at pos < S
    scores = torch.where(stale, scores + NEG_INF, scores)
    cur = torch.einsum("bkhd,bkhd->bhk", k_new, q)
    flat = scores.reshape(b, heads, lanes, lanes * s_max)
    m = torch.maximum(flat.amax(dim=-1), cur)
    pr = torch.exp(flat - m[..., None])
    pc = torch.exp(cur - m)
    den = (pr.sum(dim=-1) + pc).clamp_min(1e-30)
    pr = rnd(pr / den[..., None], kd).view(b, heads, lanes, lanes, s_max)
    pc = rnd(pc / den, kd)
    o = torch.einsum("bhkjs,bjshd->bkhd", pr, kv[:, :, :, 1])
    o = o + pc.permute(0, 2, 1)[..., None] * v_new
    xf = xf + dense(o.reshape(n, c), w_out, b_out)
    # cross-attention: the K lanes of an utterance share its source K/V
    q2 = dense(ln(xf, 1), w_q2, b_q2) * scale
    q2 = rnd(rnd(q2, wd), src_k.dtype).view(b, lanes, heads, dh)
    sk = src_k.to(cd).view(b, s_enc, heads, dh)
    sv = src_v.to(cd).view(b, s_enc, heads, dh)
    s2 = torch.einsum("bkhd,bshd->bhks", q2, sk)
    s2 = s2 + mem_bias.to(cd)[:, None, None, :]
    p2 = torch.exp(s2 - s2.amax(dim=-1, keepdim=True))
    p2 = rnd(p2 / p2.sum(dim=-1, keepdim=True).clamp_min(1e-30),
             src_v.dtype)
    o2 = torch.einsum("bhks,bshd->bkhd", p2, sv)
    xf = xf + dense(o2.reshape(n, c), w_out2, b_out2)
    hid = torch.relu(dense(ln(xf, 2), w_1, b_1))
    xf = xf + dense(hid, w_2, b_2)
    row = torch.cat([k_new, v_new], dim=2).reshape(n, 2 * c)
    kv_cache.index_copy_(1, step.clamp_max(s_max - 1), row.to(kd)[:, None])
    return xf.to(x.dtype), kv_cache


def _check(pos, x, kv_cache, src_k, src_v, mem_bias, lane_bias,
           packed: PackedLayer, lanes, heads):
    if kv_cache.dim() != 3 or kv_cache.shape[2] % 2:
        raise ValueError(f"kv_cache must be (N, S, 2C), got "
                         f"{tuple(kv_cache.shape)}")
    n, s_max, c2 = kv_cache.shape
    c = c2 // 2
    if n % lanes or c % heads:
        raise ValueError(f"N={n} / lanes={lanes} or C={c} / heads={heads} "
                         "does not divide")
    b = n // lanes
    if x.shape != (n, c) or x.dtype != packed.w_qkv.dtype:
        raise ValueError(f"x must be ({n}, {c}) in the parameter dtype "
                         f"{packed.w_qkv.dtype}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if src_k.dim() != 3 or src_k.shape[0] != b or src_k.shape[2] != c or (
            src_v.shape != src_k.shape):
        raise ValueError(f"src_k, src_v must be ({b}, S_enc, {c}), got "
                         f"{tuple(src_k.shape)}, {tuple(src_v.shape)}")
    if src_k.dtype != kv_cache.dtype or src_v.dtype != kv_cache.dtype:
        raise ValueError("src_k, src_v must be in the cache dtype")
    if mem_bias.shape != (b, src_k.shape[1]) or (
            mem_bias.dtype != torch.float32):
        raise ValueError(f"mem_bias must be fp32 ({b}, {src_k.shape[1]})")
    if lane_bias.shape != (b, lanes, s_max, lanes) or (
            lane_bias.dtype != torch.float32):
        raise ValueError(f"lane_bias must be fp32 ({b}, {lanes}, {s_max}, "
                         f"{lanes}), got {lane_bias.dtype} "
                         f"{tuple(lane_bias.shape)}")
    tensors = (x, kv_cache, src_k, src_v, mem_bias, lane_bias, *packed)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("inputs span devices")
    if any(t.dtype != packed.w_qkv.dtype for t in packed):
        raise ValueError("packed parameters must share one dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slice_cols(k_in: int, slices: int) -> int:
    """Columns of each of ``slices`` K slices of a GEMV over ``k_in``
    columns: whole 32-column chunks."""
    return _cdiv(_cdiv(k_in, 32), slices) * 32


class Plan(NamedTuple):
    """A launch of the kernel over ``grid`` blocks: the GEMVs (QKV, out,
    q2, out2, W1, W2) as (out rows, K) with the ``rows`` of their items,
    the columns ``ks`` of their K slices, the ``slices`` and the ``items``
    (row groups times slices); scratch sizes: split-K partials ``part`` and
    LayerNorm ``stats`` in floats, ``counters``."""
    grid: int
    gemvs: tuple
    rows: tuple
    ks: tuple
    slices: tuple
    items: tuple
    part: int
    stats: int
    counters: int


def gemv_shapes(c: int, f: int) -> tuple:
    """(out rows, K) of QKV, out, q2, out2, W1, W2."""
    return ((3 * c, c), (c, c), (c, c), (c, c), (f, c), (c, f))


def _stats_size(n: int, c: int) -> int:
    # LN2's and LN3's (sum, m2) a lane and row group of at least 8 columns
    return 4 * n * _cdiv(c, 8)


def _counters_size(c: int, f: int) -> int:
    return sum(_cdiv(o, 8) for o, _ in gemv_shapes(c, f))


@functools.lru_cache(maxsize=1024)
def launch_plan(n: int, c: int, f: int, grid: int, max_rows: int) -> Plan:
    """The GEMVs' items over ``grid`` co-resident blocks for n lanes: K is
    split only where items of 8 rows would leave half of the grid idle,
    into as many slices as the grid then holds (at C=1024 on the H100's
    132 blocks no GEMV is split); rows are the fewest multiple of 8 (up
    to ``max_rows``) whose items the grid holds at once, else
    ``max_rows``."""
    gemvs = gemv_shapes(c, f)
    rows, ks, slices = [], [], []
    for out, k_in in gemvs:
        groups = _cdiv(out, 8)
        cut = grid // groups if 2 * groups <= grid else 1
        cols = slice_cols(k_in, cut)
        s = _cdiv(k_in, cols)
        rows.append(next((r for r in range(8, max_rows + 1, 8)
                          if _cdiv(out, r) * s <= grid), max_rows))
        ks.append(cols)
        slices.append(s)
    items = tuple(_cdiv(o, r) * s for (o, _), r, s in zip(gemvs, rows,
                                                         slices))
    part = max([s * o * n for (o, _), s in zip(gemvs, slices) if s > 1],
               default=0)
    return Plan(grid, gemvs, tuple(rows), tuple(ks), tuple(slices), items,
                part, _stats_size(n, c), _counters_size(c, f))


@functools.lru_cache(maxsize=256)
def card_plan(n: int, lanes: int, heads: int, c: int, f: int, s_dec: int,
              s_enc: int, param_dtype, cache_dtype,
              device: int) -> tuple[Plan, int]:
    """(the launch plan, a block's dynamic shared memory in bytes) on the
    current card (``device`` keys the cache): the kernel reports its shared
    memory, the blocks a cooperative launch holds and the most rows of an
    item (``avsr_decoder_layer_config``)."""
    fn = _build.function("avsr_decoder_layer_config",
                         (ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p))
    shape = (ctypes.c_int * 5)(n, lanes, c // heads, s_dec, s_enc)
    out = (ctypes.c_int * 3)()
    _build.check("decoder_layer_step",
                 fn(_build.dtype_code(param_dtype),
                    _build.dtype_code(cache_dtype), ctypes.addressof(shape),
                    ctypes.addressof(out)))
    smem, grid, max_rows = out
    return launch_plan(n, c, f, grid, max_rows), smem


class Scratch(NamedTuple):
    """The kernel's working memory for n lanes."""

    xres: torch.Tensor  # (N, C) fp32 residual stream
    qkv: torch.Tensor  # (N, 3C) fp32
    q2: torch.Tensor  # (N, C) fp32
    opnd: torch.Tensor  # (N, max(C, F)) the GEMV operands (weight dtype)
    lnop: torch.Tensor  # (N, C) the LayerNorms' outputs (weight dtype)
    stats: torch.Tensor  # LayerNorm statistics, fp32
    part: torch.Tensor  # split-K partials, fp32, sized at the first launch
    counters: torch.Tensor  # int32, one a row group, zero between launches


def _scratch_shapes(n, c, f):
    return [(n, c), (n, 3 * c), (n, c), (n, max(c, f)), (n, c),
            (_stats_size(n, c),)]


def layer_scratch(n: int, c: int, f: int, device) -> Scratch:
    """Scratch for ``decoder_layer_step`` over n lanes: made once per decode
    and shared by its layers and steps, which run one after another."""
    fp32 = [torch.empty(shape, dtype=torch.float32, device=device)
            for shape in _scratch_shapes(n, c, f)]
    return Scratch(*fp32, torch.empty(0, dtype=torch.float32, device=device),
                   torch.zeros(_counters_size(c, f), dtype=torch.int32,
                               device=device))


# a trace holds, for each block, 2 marks for each of the kernel's PHASES
# phases and STEPS more within the phase kTraceSub of the source
PHASES, STEPS = 11, 6


def _launch(pos, x, kv_cache, src_k, src_v, mem_bias, lane_bias,
            packed: PackedLayer, lanes, heads, scratch, trace=None):
    n, s_max, c2 = kv_cache.shape
    c = c2 // 2
    f = packed.w_1.shape[0]
    dev = x.device
    if lanes > MAX_LANES:
        raise ValueError(f"the kernel takes <= {MAX_LANES} beam lanes, got "
                         f"{lanes}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if scratch is None:
        scratch = layer_scratch(n, c, f, dev)
    shapes = _scratch_shapes(n, c, f)
    if any(t.shape != shape or t.dtype != torch.float32 or t.device != dev
           or not t.is_contiguous()
           for t, shape in zip(scratch, shapes)) or (
            scratch.counters.shape != (_counters_size(c, f),)
            or scratch.counters.device != dev):
        raise ValueError(f"scratch must be layer_scratch({n}, {c}, {f}) on "
                         f"{dev}")
    plan, _ = card_plan(n, lanes, heads, c, f, s_max, src_k.shape[1],
                        x.dtype, kv_cache.dtype, dev.index)
    if scratch.part.numel() < plan.part:
        scratch.part.resize_(plan.part)
    cols = 2 * PHASES + STEPS
    if trace is not None and (trace.dtype != torch.int64 or trace.device != dev
                              or trace.numel() < plan.grid * cols):
        raise ValueError(f"trace must be int64 ({plan.grid}, {cols}) on "
                         f"{dev}")
    fn = _build.function(
        "avsr_decoder_layer",
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p),
    )
    step = _build.device_step(pos, dev)
    if x.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        x = x.clone()
    out = torch.empty_like(x)
    tensors = (x, kv_cache, src_k, src_v, mem_bias, lane_bias, *packed,
               *scratch, out)
    ptrs = (ctypes.c_void_p * (len(tensors) + 2))(
        *(t.data_ptr() for t in tensors),
        0 if trace is None else trace.data_ptr(), step.data_ptr())
    dims = (ctypes.c_int * 21)(
        n, lanes, heads, c // heads, c, f, s_max, src_k.shape[1],
        plan.grid, *plan.rows, *plan.ks)
    scale = (c // heads) ** -0.5  # ctypes.c_float rounds it to fp32
    err = fn(ctypes.addressof(ptrs), ctypes.addressof(dims), scale,
             _build.dtype_code(x.dtype), _build.dtype_code(kv_cache.dtype),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("decoder_layer_step", err)
    decoder_layer_step.launches += 1
    return out, kv_cache


def decoder_layer_step(pos, x, kv_cache, src_k, src_v, mem_bias,
                       lane_bias, packed: PackedLayer, lanes: int,
                       heads: int, scratch: Scratch | None = None,
                       trace=None):
    """One decoder layer's decode step for all N = B*lanes beam lanes.

    pos: the step's position, a one-element int32 or int64 tensor on the
    inputs' device (the kernel reads it there; the wrapper does not) or an
    int (made into one); x (N, C) the residual stream in the
    parameter dtype; kv_cache (N, S, 2C) fused K|V in the cache dtype;
    src_k, src_v (B, S_enc, C) the layer's source keys and values (heads
    packed) in the cache dtype; mem_bias (B, S_enc) fp32, 0 for a valid
    source row and -1e30 for padding; lane_bias (B, K, S, J) fp32, 0 where
    stored lane j at row s is an ancestor of lane k, -1e30 elsewhere,
    including every row s > pos on every lane (the kernel skips those
    rows); packed: ``pack_layer_params``; scratch: ``layer_scratch(N, C,
    F, device)`` to reuse (the card only; made per call without it);
    trace: an int64 tensor of (grid, 2 * PHASES + STEPS) on the card, or
    None, which the kernel fills with each block's global timer (ns) at the
    start and at the end of each phase, then at the steps of one phase
    (``tools/layer_variants.py`` reads it).

    Returns (x_out (N, C) in x's dtype, kv_cache) with this step's K|V row
    written at min(pos, S-1) IN PLACE. On the card it is one cooperative
    launch at any batch."""
    _check(pos, x, kv_cache, src_k, src_v, mem_bias, lane_bias, packed,
           lanes, heads)
    if x.device.type == "cpu":
        warm_exp()
        return decoder_layer_step_plain(pos, x, kv_cache, src_k, src_v,
                                        mem_bias, lane_bias, packed, lanes,
                                        heads)
    if x.device.type != "cuda":
        raise ValueError(f"no decoder_layer_step for device {x.device}")
    return _launch(pos, x, kv_cache, src_k, src_v, mem_bias, lane_bias,
                   packed, lanes, heads, scratch, trace)


decoder_layer_step.launches = 0
