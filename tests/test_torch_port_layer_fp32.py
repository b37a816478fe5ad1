"""The one-launch decoder layer's fp32 path, its arithmetic emulated on the
CPU.

``csrc/decoder_layer.cu`` runs the fp32 GEMVs on the tensor cores in
split TF32: every operand and weight value x = hi + lo (hi rounded to
TF32, lo = x - hi truncated to TF32, ``mma_tf32.cuh`` ``split_tf32``) and
each k8 product as lo_a hi_b, hi_a lo_b, then hi_a hi_b into fp32
accumulators (``mma_split``'s order), in a k permutation that lets a
lane's two 16-byte loads of a 32-column chunk feed its four products
(``tf32_column``). With 64-wide heads the attention's q.k and P.V run in
split TF32 too (keys and values as the A operand, the queries and P as
B), the softmax between them unchanged (exact exp, fixed order).
``tests/test_torch_port_layer.py`` ``emulate_gemv`` and
``emulate_attention`` repeat that product by product, with the kernel's
stages, warps' chunks and row groups and the warps' and K slices' sums in
order; here the emulated layer is held against the plain twin and the JAX
Pallas kernel (interpret mode) within 2e-5 of the largest entry, the
card's fp32 limit, at two widths (16- and 64-wide heads), 3-5 lanes and
8-32 lanes (one-pass and two-pass attention), and the source is pinned to
the emulated design. The kernel itself runs on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from avsr_tpu_torch.ops.kernels import _build  # noqa: E402
from avsr_tpu_torch.ops.kernels import decoder_layer as pdl  # noqa: E402
from tests.test_torch_port_layer import (  # noqa: E402
    BE, MAX_ROWS, SE, TF32_COLUMNS, _case, _jax_step, emulate_layer,
    tf32_column)
from tests.torch_port_common import setup_torch, tf32_rna  # noqa: E402

TOL = 2e-5  # the card's fp32 limit, relative to the largest entry
SOURCE = _build.CSRC_DIR / "decoder_layer.cu"
HELPERS = _build.CSRC_DIR / "mma_tf32.cuh"


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


def _errors(pos, c, heads, f, lanes, seed, plan, tile=None,
            products=None):
    """max |emulated - reference| / max |reference| of x_out and the
    written row, against the twin and against JAX."""
    layer, packed, args = _case(pos, seed, torch.float32, lanes, c, heads,
                                f)
    kw = {} if products is None else {"products": products}
    got_x, got_row = emulate_layer(pos, *args, packed, lanes, heads, plan,
                                   tile=tile, **kw)
    want_x, want_kv = pdl.decoder_layer_step_plain(
        pos, *(a.clone() for a in args), packed, lanes, heads)
    jax_x, jax_row = _jax_step(pos, layer, args, torch.float32, lanes, heads)
    out = {}
    for name, got, want in (
            ("x_out", got_x, want_x.numpy()),
            ("row", got_row, want_kv[:, min(pos, SE - 1)].numpy()),
            ("x_out vs JAX", got_x, jax_x), ("row vs JAX", got_row, jax_row)):
        out[name] = np.abs(got.numpy() - want).max() / np.abs(want).max()
    return out


def _plan(n, c, f, split):
    """The launch plan over the H100's 132 blocks, or with every GEMV cut
    into 2-4 K slices of 8-32-row items."""
    plan = pdl.launch_plan(n, c, f, 132, MAX_ROWS)
    if split:
        ks = tuple(pdl.slice_cols(k_in, s) for (_, k_in), s in
                   zip(plan.gemvs, (2, 3, 4, 2, 3, 4)))
        plan = plan._replace(
            rows=(16, 8, 32, 24, 8, 16), ks=ks,
            slices=tuple(-(-k_in // k) for (_, k_in), k in zip(plan.gemvs,
                                                              ks)))
    return plan


def test_tf32_permutation_feeds_each_lane_its_own_loads():
    """Each 32-column chunk's four k8 products take every column once, and
    lane t's logical k = t and t + 4 of product 2h + j are physical
    8t + 4h + 2j and the next: the 4 floats of the lane's 16-byte load h,
    so no value crosses lanes."""
    assert sorted(c for cols in TF32_COLUMNS for c in cols) == list(range(32))
    for p in range(4):
        h, j = divmod(p, 2)
        for t in range(4):
            lo, hi = tf32_column(p, t), tf32_column(p, t + 4)
            assert (lo, hi) == (8 * t + 4 * h + 2 * j, 8 * t + 4 * h + 2 * j
                                + 1)
            assert 8 * t + 4 * h <= lo < hi < 8 * t + 4 * h + 4


@pytest.mark.parametrize("pos", [0, 7, SE + 3])
@pytest.mark.parametrize("lanes", [3, 5])
@pytest.mark.parametrize("c,heads,f", [(64, 4, 128), (128, 2, 256)])
@pytest.mark.parametrize("split", [False, True])
def test_split_tf32_layer_matches_plain_and_jax(pos, lanes, c, heads, f,
                                                split):
    """The layer with the kernel's split-TF32 GEMVs (C = 64 with four
    16-wide heads and C = 128 with two 64-wide heads, F = 2C, 3 and 5
    lanes; items as planned over 132 blocks, or cut into 2-4 K slices):
    x_out and the written row within 2e-5 of the largest entry of the twin
    and of JAX's ``decoder_layer_step`` (interpret), the attention in the
    kernel's one-pass order (split TF32 at the 64-wide heads, CUDA cores
    at the 16-wide). At pos = S + 3 all S stored rows and the fresh one
    are attended."""
    plan = _plan(BE * lanes, c, f, split)
    assert not split or min(plan.slices) > 1
    errs = _errors(pos, c, heads, f, lanes, 40 + pos + lanes, plan, 560)
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("lanes,tile", [(8, 560), (22, 32), (32, 48)])
@pytest.mark.parametrize("pos", [7, SE + 3])
def test_split_tf32_layer_at_wide_beams(lanes, tile, pos):
    """The same up to the kernel's 32 lanes, its attention in the kernel's
    order: one pass (8 lanes) or two over tiles of the rows (22 and 32
    lanes), at C = 128, F = 256: within 2e-5 of the twin and of JAX."""
    plan = pdl.launch_plan(BE * lanes, 128, 256, 132, MAX_ROWS)
    errs = _errors(pos, 128, 2, 256, lanes, 60 + pos + lanes, plan, tile)
    assert max(errs.values()) <= TOL, errs


def test_one_tf32_product_would_miss_the_limit():
    """The limit tells split TF32 from one TF32 product: with each operand
    only rounded to TF32 (lo = 0, so one hi hi product a step) the
    emulated layer misses 2e-5 of the twin's largest entry."""
    def one(x):
        return tf32_rna(x), torch.zeros_like(x)

    plan = pdl.launch_plan(BE * 3, 128, 256, 132, MAX_ROWS)
    errs = _errors(SE + 3, 128, 2, 256, 3, 43, plan, products=one)
    assert errs["x_out"] > TOL, errs


def test_fp32_attention_source_is_the_emulated_design():
    """The attention the emulation stands for: 64-wide heads take the mma
    path in either cache dtype; in fp32 q.k feeds the split keys (rows g,
    g + 8, dims 8c..8c+7 of each 32) to every query tile through
    ``mma_split_rows``, P.V takes V^T's rows 2c and 2c + 1 as k = c and
    c + 4 and P's pair split once, with one query tile the three terms
    issued across the four head slices, with more across the query tiles;
    the softmax keeps the exact expf."""
    src = SOURCE.read_text()
    body = re.search(r"__device__ void attend\(.*?\n}\n", src,
                     re.S).group(0)
    assert "const bool mma = dh == kMmaDh;" in body
    assert "if (mma && !kBf16) {" in body
    assert ("const float* k0 = kf + (t16 + gq) * ld + 32 * hf + 8 * c4;"
            in body)
    assert ("avsr::tf32::split_a(ahi, alo, r0[2 * p], r8[2 * p],\n"
            in body)
    assert "qs + kq * dh + 32 * hf + 8 * c4 + 2 * p)" in body
    assert ("avsr::tf32::mma_split_rows<kQTiles>(acc, ahi, alo, bhi, blo,"
            in body)
    assert "const int r = t16 + s8 + 2 * c4;" in body
    assert body.count("v[0], v[8], v[ld],") == 2
    assert "avsr::tf32::mma_split_rows<4>(oacc, ahi, alo, bhi, blo, nq);" \
        in body
    terms = re.findall(r"mma_tf32\(oacc\[m4\], (\w+)\[m4\], (\w+)\[0\]",
                       body)
    assert terms == [("alo", "bhi"), ("ahi", "blo"), ("ahi", "bhi")]
    assert "expf(srow[e] - safe)" in body and "__expf" not in body


def test_fp32_gemv_source_is_the_emulated_design():
    """The kernel the emulation stands for: the CUDA-core fp32 GEMV (a warp
    sum a lane) is gone; the fp32 item_products stages up to kMaxKsBytes /
    4 = 512 columns (the warps' sums alias the stage, as in bf16), reads
    the weights a chunk at a time as lane t's two 16-byte loads at
    8t + 4h, splits them as
    the products .x/.y and .z/.w, the operand rows g and g + 8 from rows
    padded by 4 floats, and issues the three terms across the row tiles
    (``mma_split_rows``, lo hi, hi lo, hi hi); the bf16 GEMV is the
    m16n8k16 one."""
    src = SOURCE.read_text()
    helpers = HELPERS.read_text()
    assert '#include "mma_tf32.cuh"' in src
    assert "avsr::warp_sum(acc[q])" not in src
    assert "return kMaxKsBytes / wsize;" in src
    assert "constexpr int kBatchF32 = 1;" in src
    assert "float* wres = reinterpret_cast<float*>(smem);" in src
    assert "return sizeof(TW) == 2 ? cdiv(cols, 64) * 64 + 32 : cols + 4;" \
        in src
    body = re.search(r"void item_products\(const float\* __restrict__ w,"
                     r".*?\n}\n", src, re.S).group(0)
    assert "const int col = kb + (cb + u) * 32 + 8 * t + 4 * h;" in body
    assert "ld_stream(w + static_cast<size_t>(row) * in + col)" in body
    for j, (x, y) in enumerate((("x", "y"), ("z", "w"))):
        assert (f"split_tf32(__uint_as_float(v.{x}), bhi[{j}][nt][0],"
                in body)
        assert (f"split_tf32(__uint_as_float(v.{y}), bhi[{j}][nt][1],"
                in body)
        assert (f"split_a(ahi, alo, r0.{x}, r8.{x}, r0.{y}, r8.{y});"
                in body)
    assert body.count("mma_split_rows<kMaxRowTiles>(") == 2
    assert "arow + (mt * 16 + 8) * ld + 4 * h" in body
    assert "mma16816" not in body
    rows = re.search(r"void mma_split_rows\(.*?\n}\n", helpers,
                     re.S).group(0)
    order = re.findall(r"mma_tf32\(d\[i\], (\w+), (\w+)\[i\]\[0\]", rows)
    assert order == [("alo", "bhi"), ("ahi", "blo"), ("ahi", "bhi")]
