"""The beam's decode attention (B2) with an fp32 cache, its split-TF32
arithmetic emulated on the CPU.

``csrc/decode_attention.cu`` runs q.k and P.V of an fp32 cache with 64-wide
heads on the tensor cores in split TF32 (``mma_tf32.cuh``: x = hi + lo, hi
rounded to TF32, lo = x - hi truncated, three m16n8k8 products a k-step,
lo hi, hi lo, hi hi): S = K q^T with the keys as the A operand and the
queries as B, in the k permutation of the one-launch layer's (each 32 of
the head's dims as four k8 products, lane c's dims 8c..8c+7); out^T =
V^T P^T with the values as A over k8 steps of 8 rows, warp (head slice,
row half) summing its half's 16-row groups of every tile; the softmax
between them exact (the rank's (max, shifted sum) per chunk, combined over
the cluster in rank order, p = exp(s - m) / den); the rank's two row
halves added, then the ranks' partials in rank order. ``emulate_tf32``
repeats that in torch, step by step, and is held against the plain twin
and the JAX Pallas kernel (interpret mode) within ``output_bound``
(ROADMAP C27) at the conformer's (C=768, 12 heads) and the flagship's
(C=1024, 16 heads) widths. The kernel itself runs on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import functools
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu_torch.ops.kernels import _build  # noqa: E402
from avsr_tpu_torch.ops.kernels import decode_attention as pda  # noqa: E402
from tests.test_torch_port_decode import _combine  # noqa: E402
from tests.test_torch_port_layer import split_scores  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    decode_case, setup_torch, split_tf32, t, tf32_rna)

SOURCE = _build.CSRC_DIR / "decode_attention.cu"
S_MAX = 192  # the serving cache's rows
WIDTHS = [(768, 12), (1024, 16)]  # the conformer's and the flagship's


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


def split_pv(p, values, plan, rows, products):
    """One rank's P.V as the kernel forms it: p (..., K, R) and values (...,
    R, dh) of the rank's rows in order; per tile of ``plan.tile`` rows,
    half h's 16-row groups h, h + 2, ... each as two k8 steps of 8 rows
    (zeros past the tile), every step lo_v hi_p, hi_v lo_p, hi_v hi_p into
    the half's fp32 sums, which run over all the rank's tiles; then the two
    halves added. (Each step's three products are formed at once for all
    the steps; their sums run step by step.)"""
    zero_p = torch.zeros(*p.shape[:-1], 1)
    zero_v = torch.zeros(*values.shape[:-2], 1, values.shape[-1])
    ph, pl = products(torch.cat([p, zero_p], -1))  # row R: zeros
    vh, vl = products(torch.cat([values, zero_v], -2))
    halves = []
    for half in (0, 1):
        steps = [[r if r < base + n else rows for r in range(r0, r0 + 8)]
                 for base in range(0, rows, plan.tile)
                 for n in [min(plan.tile, rows - base)]
                 for t16 in range(half * 16, n, 32)
                 for r0 in (base + t16, base + t16 + 8)]
        acc = torch.zeros(*p.shape[:-1], values.shape[-1])
        if steps:
            i = torch.tensor(steps)  # (steps, 8)
            terms = [torch.einsum("...kgr,...grd->g...kd", b[..., i],
                                  a[..., i, :])
                     for a, b in ((vl, ph), (vh, pl), (vh, ph))]
            for st in range(len(steps)):
                for term in terms:
                    acc = acc + term[st]
        halves.append(acc)
    return halves[0] + halves[1]


def emulate_tf32(pos, q, kv_cache, lane_bias, lanes, heads, kv_row, plan,
                 products=split_tf32):
    """The fp32 cache's kernel arithmetic in torch: rows (s <= pos_c, j)
    s-major, row pos_c from kv_row; each score the bias plus K q^T in split
    TF32 (``split_scores``: the k8 products in the kernel's order); per
    rank, per chunk the (max, shifted sum), folded in chunk order, the
    ranks' combined in rank order; p = exp(s - m) / den in fp32; each
    rank's P.V (``split_pv``), the ranks' partials summed in rank order.
    ``products`` splits an operand into (hi, lo)."""
    n, s_max, c2 = kv_cache.shape
    c, b = c2 // 2, n // lanes
    dh = c // heads
    pos_c = min(pos, s_max - 1)
    kv = kv_cache.view(b, lanes, s_max, 2, heads, dh)[:, :, :pos_c + 1]
    kv = kv.clone()
    kv[:, :, pos_c] = kv_row.view(b, lanes, 2, heads, dh)
    kv = kv.transpose(1, 2).reshape(b, plan.rows, 2, heads, dh)
    keys = kv[:, :, 0].permute(0, 2, 1, 3)  # (B, H, R, dh)
    values = kv[:, :, 1].permute(0, 2, 1, 3)
    qq = q.float().view(b, lanes, heads, dh).permute(0, 2, 1, 3)
    bias = lane_bias[:, :, :pos_c + 1].reshape(b, 1, lanes, plan.rows)
    scores = bias + split_scores(qq, keys, products)  # (B, H, K, R)
    m = torch.full(scores.shape[:-1], float("-inf"))
    den = torch.zeros(scores.shape[:-1])
    for r in range(plan.cluster):
        m_r, l_r = torch.full_like(m, float("-inf")), torch.zeros_like(den)
        for ch in plan.rank_chunks(r):
            part = scores[..., ch.start:ch.stop]
            mx = part.amax(dim=-1)
            sm = torch.exp(part - mx.clamp_min(-3.0e38)[..., None]).sum(-1)
            m_r, l_r = _combine(m_r, l_r, mx, sm)
        m, den = _combine(m, den, m_r, l_r)
    p = torch.exp(scores - m[..., None]) / den.clamp_min(1e-30)[..., None]
    out = torch.zeros(*qq.shape)
    for r in range(plan.cluster):
        rows = plan.rank_rows(r)
        if len(rows):
            out = out + split_pv(p[..., rows.start:rows.stop],
                                 values[:, :, rows.start:rows.stop], plan,
                                 len(rows), products)
    return out.permute(0, 2, 1, 3).reshape(n, c)


@functools.lru_cache(maxsize=None)
def _jax_kernel(lanes, heads):
    from avsr_tpu.ops.pallas.decode_attention import decode_attention

    return jax.jit(functools.partial(decode_attention, lanes=lanes,
                                     heads=heads, resident=True))


def _case(pos, lanes, c, heads, seed):
    """B=1 at the model's widths over a 192-row fp32 cache, the queries
    scaled as the decoder scales them."""
    return decode_case(seed, 1, lanes, S_MAX, heads, c // heads, pos,
                       q_scale=0.125)


def _ratio(got, want, bound):
    return float(((got - want).abs() / bound).max())


@pytest.mark.parametrize("pos", [0, 5, 191, 250])
@pytest.mark.parametrize("lanes", [3, 22])
@pytest.mark.parametrize("c,heads", WIDTHS)
def test_split_tf32_decode_matches_plain_and_jax(pos, lanes, c, heads):
    """The emulated kernel against the twin and JAX's ``decode_attention``
    (resident v3, interpret) within ``output_bound``, element by element,
    at beam 3 and 22 lanes, pos 0, 5, 191 and 250 (past the cap: the
    whole cache and the row at S-1), with the launch plan of an fp32 cache
    (its cluster size, tiles and chunks); JAX's cache after the row write
    the twin's bit for bit."""
    q, kv, row, bias = _case(pos, lanes, c, heads, lanes + pos + c)
    plan = pda.launch_plan(1, lanes, heads, 64, S_MAX, 4).at(pos)
    got = emulate_tf32(pos, t(q), t(kv), t(bias), lanes, heads, t(row),
                       plan)
    want, want_kv = pda.decode_attention_plain(pos, t(q), t(kv).clone(),
                                               t(bias), lanes, heads, t(row))
    jout, jkv = _jax_kernel(lanes, heads)(
        jnp.asarray(pos), jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bias),
        kv_row=jnp.asarray(row))
    bound = pda.output_bound(pos, t(q), t(kv), t(bias), lanes, heads, t(row))
    jax_out = torch.from_numpy(np.array(jout))
    assert _ratio(got, want, bound) <= 1.0
    assert _ratio(got, jax_out, bound) <= 1.0
    np.testing.assert_array_equal(want_kv.numpy(), np.asarray(jkv))


@pytest.mark.parametrize("cluster", [1, 8])
def test_split_tf32_decode_at_forced_clusters(cluster):
    """The same at C=768 with one block a pair (G=1: one rank, its rows in
    several tiles) and G=8 (short ranks, some with one tile), 22 lanes at
    pos 191: within ``output_bound`` of the twin."""
    q, kv, row, bias = _case(191, 22, 768, 12, cluster)
    plan = pda.launch_plan(1, 22, 12, 64, S_MAX, 4, cluster).at(191)
    assert plan.cluster == cluster
    got = emulate_tf32(191, t(q), t(kv), t(bias), 22, 12, t(row), plan)
    want, _ = pda.decode_attention_plain(191, t(q), t(kv), t(bias), 22, 12,
                                         t(row))
    bound = pda.output_bound(191, t(q), t(kv), t(bias), 22, 12, t(row))
    assert _ratio(got, want, bound) <= 1.0


def test_one_tf32_product_would_miss_the_bound():
    """The bound tells split TF32 from one TF32 product: with each operand
    only rounded to TF32 (lo = 0, one hi hi product a k-step) the emulated
    kernel lands beyond ``output_bound`` of the twin (C=768, beam 3, pos
    250), while the split lands well inside it."""
    def one(x):
        return tf32_rna(x), torch.zeros_like(x)

    q, kv, row, bias = _case(250, 3, 768, 12, 7)
    plan = pda.launch_plan(1, 3, 12, 64, S_MAX, 4).at(250)
    want, _ = pda.decode_attention_plain(250, t(q), t(kv), t(bias), 3, 12,
                                         t(row))
    bound = pda.output_bound(250, t(q), t(kv), t(bias), 3, 12, t(row))
    ratios = {name: _ratio(emulate_tf32(250, t(q), t(kv), t(bias), 3, 12,
                                        t(row), plan, products), want, bound)
              for name, products in (("split", split_tf32), ("one", one))}
    assert ratios["one"] > 1.0 and ratios["split"] < 0.5, ratios


@pytest.mark.parametrize("lanes,b,pos,s_max,c,heads", [
    (3, 8, 250, 192, 768, 12), (3, 32, 250, 192, 768, 12),
    (3, 8, 250, 192, 1024, 16), (22, 8, 74, 128, 1024, 16),
    (22, 32, 74, 128, 1024, 16), (64, 8, 250, 192, 768, 12)])
def test_fp32_plan_fits_shared_memory(lanes, b, pos, s_max, c, heads):
    """At the shapes the card times (and a beam of 64), an fp32 cache's
    launch plan holds the queries' split B fragments (hi and lo of whole
    8-query tiles) and fits a block's shared memory; beam 3 and 22 lanes
    take one pass with two blocks an SM (beam 3: G=2 at B=8 and B=32
    alike, two stage buffers of 192 rows)."""
    plan = pda.launch_plan(b, lanes, heads, 64, s_max, 4)
    tiles = -(-plan.group_lanes // pda.MAX_LANES)
    assert pda.query_words(plan.group_lanes, 64, 4) == 2 * tiles * 8 * 64
    assert plan.smem == pda.smem_bytes(plan.group_lanes, 64, 4, plan.chunk,
                                       plan.tile) <= pda.SMEM_MAX
    if lanes <= 22:
        assert plan.chunk == plan.rows_per_rank and plan.smem <= pda.PAIR_SMEM
    if lanes == 3:
        assert (plan.cluster, plan.tile) == (2, 192)
    assert pda.query_words(3, 32, 4) == 3 * 32  # other widths: (lanes, dh)
    assert pda.query_words(3, 64, 2) == 3 * 64  # bf16: the pairs' room


def test_tf32_source_is_the_emulated_design():
    """The kernel the emulation stands for: 64-wide heads of either cache
    dtype take the mma instances; the fp32 queries split once into B
    fragments (dims 32 hf + 8c + 2p and the next of query g); q.k feeds the
    split keys (rows g, g + 8, dims 8c..8c+7 of each 32) to every query
    tile through ``mma_split_rows``; P.V takes V^T's rows 2c and 2c + 1 of
    each 8 as k = c and c + 4, warp (head slice, row half) over its half's
    16-row groups, the halves added in order; the fp32 softmax keeps expf
    and div_rn; no single TF32 product; the query room is the plan's."""
    src = SOURCE.read_text()
    assert '#include "mma_tf32.cuh"' in src
    assert "constexpr bool kTf = kMma && sizeof(TC) == 4;" in src
    launch = re.search(r"cudaError_t launch_lanes\(.*?\n}\n", src,
                       re.S).group(0)
    assert "sizeof(TC)" not in launch
    assert "if (mma && dh == kMmaDh) {" in launch
    assert "const int d = 32 * (st >> 2) + 8 * (ln & 3) + 2 * (st & 3);" \
        in src
    assert "avsr::tf32::split_tf32(x0, f.x, f.z);" in src
    assert "const float* k0 = kf + (t16 + gq) * ld + 32 * hf + 8 * c4;" \
        in src
    assert ("avsr::tf32::split_a(ahi, alo, r0[2 * p], r8[2 * p],\n" in src)
    assert "qf[(nt * 8 + 4 * hf + p) * 32 + lane_id]" in src
    assert "mma_split_rows<kNt>(acc, ahi, alo, bhi, blo, nqt);" in src
    assert "const int r = t16 + s8 + 2 * c4;" in src
    assert "avsr::tf32::split_a(ahi, alo, v[0], v[8], v[ld], v[ld + 8]);" \
        in src
    assert "mma_split_rows<kNt>(oacc, ahi, alo, bhi, blo, nqt);" in src
    assert src.count("for (int t16 = half * 16; t16 < n; t16 += 32) {") == 2
    assert "*o = h2 ? oacc[nt][e] : oacc[nt][e] + *o;" in src
    assert "soft_exp<kBf>(srow[e + 32 * u] - safe)" in src
    assert "avsr::mma::div_rn(\n                expf(x[u][0])" in src
    assert "mma_tf32(" not in src  # only the split products
    assert ("? 2 * static_cast<size_t>((lanes + kTileLanes - 1) /\n"
            "                                       kTileLanes * kTileLanes)"
            " * dh\n             : static_cast<size_t>(lanes) * dh;") in src
    assert f"constexpr int kMmaDh = {pda.MMA_DH};" in src
