"""The fp32 flash kernels' split-TF32 arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` ``flash_fwd_tf32`` forms every product on the
tensor cores in split TF32: each operand x = hi + lo with hi = x rounded
to TF32 (as ``cvt.rna.tf32.f32`` rounds) and lo = x - hi truncated to
TF32, and a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b in fp32 accumulators,
over 64-key tiles (32 at D = 128) with an online softmax (exact exp) and
the pre-scaled dropout mask applied to P before P V. The CUDA kernel
runs only on the card (tests/test_torch_port_cuda.py, chip_smoke.py);
here the same arithmetic, in torch on the CPU, is held against the JAX
``flash_attention`` (Pallas, interpret mode) and the port's fp32 twin
within 1e-5 of the largest output, a tenth of the card's 1e-4.

``csrc/flash_attention_bwd.cu`` ``flash_bwd_dq_tf32`` and
``flash_bwd_dkv_tf32`` form the backward's products the same way: dq over
32-key tiles (16 at D = 128) recomputes S = Q K^T and dP = dO V^T, forms
dS = P o (dP o M - delta) with the exact exp and adds dS K; dkv over
32-query tiles (16 at D = 128) recomputes S^T = K Q^T and dP^T = V dO^T
and adds P~^T dO and dS^T Q. Their emulation is held against ``jax.vjp``
of the JAX kernel and the twin within 1e-5 of each gradient's largest
entry.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu_torch.ops.kernels import flash_attention as pfa  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    setup_torch, split_tf32, t, tf32_rna)

NEG = -1.0e30
TILE = 64  # the kernel's keys a streamed tile at D <= 64 (kKeysF32)


def tile(d: int) -> int:
    """Keys a tile at head dim d (``F32Layout::kKeys``)."""
    return TILE if d <= 64 else TILE // 2
CSRC = Path(pfa.__file__).resolve().parents[2] / "csrc"
SOURCE = CSRC / "flash_attention.cu"
BWD_SOURCE = CSRC / "flash_attention_bwd.cu"
HELPERS = CSRC / "mma_tf32.cuh"  # the split-TF32 helpers of all three
DQ_TILE = 32  # keys a dq tile at D <= 64 (kDqKeysF32)
DKV_TILE = 32  # queries a dkv tile at D <= 64 (kDkvQueriesF32)


def bwd_tiles(d: int) -> tuple[int, int]:
    """(keys a dq tile, queries a dkv tile) at head dim d
    (``BwdF32::kDqCols``, ``kDkvCols``)."""
    return (DQ_TILE, DKV_TILE) if d <= 64 else (DQ_TILE // 2, DKV_TILE // 2)


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched) in split TF32: the two small products, then
    hi_a hi_b, each in fp32, summed in that order."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def split_tf32_attention(q, k, v, bias, scale, mask=None):
    """(out, lse) with the kernel's arithmetic: S = Q K^T in split TF32,
    scaled and biased; per tile of keys the row max m grows, l and O are
    rescaled by exp(m_old - m_new), P = exp(S - m) (l sums the undropped
    P), P times the pre-scaled mask, O += P V in split TF32; out = O / l,
    lse = m + log l."""
    n, tt, d = q.shape
    m = torch.full((n, tt), -torch.inf)
    l = torch.zeros(n, tt)
    o = torch.zeros(n, tt, d)
    for k0 in range(0, tt, tile(d)):
        sl = slice(k0, min(k0 + tile(d), tt))
        s = split_mm(q, k[:, sl].transpose(1, 2)) * scale + bias[:, None, sl]
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mn)
        p = torch.exp(s - mn[..., None])
        l = l * alpha + p.sum(-1)
        m = mn
        if mask is not None:
            p = p * mask[:, :, sl]
        o = o * alpha[..., None] + split_mm(p, v[:, sl])
    l = l.clamp_min(1e-30)
    return o * (1.0 / l)[..., None], m + torch.log(l)


def split_tf32_backward(q, k, v, bias, out, do, lse, scale, mask=None):
    """(dq, dk, dv, delta) with the backward kernels' arithmetic, given
    the forward's out and lse: delta = rowsum(dO o O); dq over key tiles
    (S = Q K^T and dP = dO V^T in split TF32, P = exp(S scale + bias -
    lse), dS = P o (dP o M - delta), dQ += dS K in split TF32), times
    scale; dk and dv over query tiles (S^T = K Q^T and dP^T = V dO^T,
    dV += P~^T dO and dK += dS^T Q, each in split TF32), dk times scale."""
    n, tt, d = q.shape
    dq_cols, dkv_cols = bwd_tiles(d)
    delta = (do * out).sum(-1)
    dq = torch.zeros(n, tt, d)
    for k0 in range(0, tt, dq_cols):
        sl = slice(k0, min(k0 + dq_cols, tt))
        s = split_mm(q, k[:, sl].transpose(1, 2))
        p = torch.exp(s * scale + bias[:, None, sl] - lse[..., None])
        dp = split_mm(do, v[:, sl].transpose(1, 2))
        if mask is not None:
            dp = dp * mask[:, :, sl]
        dq = dq + split_mm(p * (dp - delta[..., None]), k[:, sl])
    dk = torch.zeros(n, tt, d)
    dv = torch.zeros(n, tt, d)
    for q0 in range(0, tt, dkv_cols):
        sl = slice(q0, min(q0 + dkv_cols, tt))
        st = split_mm(k, q[:, sl].transpose(1, 2))  # (keys, queries)
        p = torch.exp(st * scale + bias[..., None] - lse[:, None, sl])
        dpt = split_mm(v, do[:, sl].transpose(1, 2))
        pm = p
        if mask is not None:
            m = mask[:, sl].transpose(1, 2)
            pm, dpt = p * m, dpt * m
        dv = dv + split_mm(pm, do[:, sl])
        dk = dk + split_mm(p * (dpt - delta[:, None, sl]), q[:, sl])
    return dq * scale, dk * scale, dv, delta


def _case(d: int, with_mask: bool):
    rng = np.random.RandomState(d + 7 * with_mask)
    n, tt = 4, 375
    q, k, v = (rng.randn(n, tt, d).astype(np.float32) for _ in range(3))
    lens = np.asarray([tt, 301, 200, 1])  # ragged, one row of one key
    bias = np.where(np.arange(tt)[None] < lens[:, None], 0.0, NEG)
    mask = None
    if with_mask:
        keep = rng.rand(n, tt, tt) < 0.9
        mask = keep.astype(np.float32) * np.float32(1.0 / 0.9)
    return q, k, v, bias.astype(np.float32), mask


def test_tf32_rna_rounds_to_nearest_ties_away():
    """Halfway cases go away from zero, the carry reaches the exponent,
    TF32 values stay, and the result is the nearest 10-bit mantissa."""
    one = 1.0
    ulp = 2.0 ** -10
    cases = {
        one + ulp / 2: one + ulp,  # tie: away from zero
        -(one + ulp / 2): -(one + ulp),
        one + ulp / 2 - 2.0 ** -23: one,  # just below the tie
        2.0 - 2.0 ** -23: 2.0,  # carry into the exponent
        one + 3 * ulp: one + 3 * ulp,  # a TF32 value stays
        0.0: 0.0,
        float("inf"): float("inf"),
    }
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    r = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    got = tf32_rna(r).double()
    step = torch.exp2(torch.floor(torch.log2(r.double().abs())) - 10)
    assert ((got - r.double()).abs() <= step / 2).all()
    assert (got / step == torch.round(got / step)).all()


def test_split_product_drops_only_lo_lo():
    """hi + lo holds x to 2^-21 of |x| (lo, at most 2^-11 of |x|, keeps 10
    of its bits), and the three-product sum holds a b to 2^-19 of |a b|
    (float64 reference), where one TF32 product is off by up to 2^-10; a
    NaN stays a NaN in lo."""
    rng = np.random.RandomState(1)
    a, b = (torch.from_numpy(rng.randn(20000).astype(np.float32) * 3)
            for _ in range(2))
    hi, lo = split_tf32(a)
    assert (lo.abs() <= 2.0 ** -11 * a.abs()).all()
    assert ((hi.double() + lo.double() - a.double()).abs()
            <= 2.0 ** -21 * a.double().abs()).all()
    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)
    assert torch.isnan(split_tf32(nan)[1]).all()
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    exact = a.double() * b.double()
    three = (al.double() * bh.double() + ah.double() * bl.double()
             + ah.double() * bh.double())
    one = ah.double() * bh.double()
    assert ((three - exact).abs() <= 2.0 ** -19 * exact.abs()).all()
    assert ((one - exact).abs() > 2.0 ** -16 * exact.abs()).any()


def test_one_tf32_product_would_miss_the_limit(monkeypatch):
    """The limits tell split TF32 from plain TF32: with one TF32 product
    a step (hi_a hi_b alone) the same attention lies ~2e-4 of its largest
    output from the twin, past the card's 1e-4."""
    monkeypatch.setattr(sys.modules[__name__], "split_mm",
                        lambda a, b: tf32_rna(a) @ tf32_rna(b))
    q, k, v, bias, _ = _case(64, False)
    got, _ = split_tf32_attention(t(q), t(k), t(v), t(bias), 0.125)
    twin, _ = pfa.flash_attention_plain(t(q), t(k), t(v), t(bias), 0.125)
    assert (got - twin).abs().max() > 1e-4 * twin.abs().max()


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_split_tf32_forward_matches_jax_and_twin(d, with_mask):
    """N=4, T=375 (not a multiple of the 64-key tile or of 128) with
    ragged key lengths and a row of one key, with and without an explicit
    pre-scaled dropout mask: the emulated kernel against the JAX
    ``flash_attention`` (interpret mode) and the fp32 twin, out within
    1e-5 of its largest entry; lse against the twin's within 1e-5 of its
    largest."""
    from avsr_tpu.ops.pallas.flash_attention import flash_attention

    q, k, v, bias, mask = _case(d, with_mask)
    scale = d ** -0.5
    got, lse = split_tf32_attention(t(q), t(k), t(v), t(bias), scale,
                                    None if mask is None else t(mask))
    want_jax = np.asarray(flash_attention(
        *(jnp.asarray(x) for x in (q, k, v, bias)), scale=scale,
        dropout_mask=None if mask is None else jnp.asarray(mask)))
    twin, twin_lse = pfa.flash_attention_plain(
        t(q), t(k), t(v), t(bias), scale,
        dropout_mask=None if mask is None else t(mask))
    top = np.abs(want_jax).max()
    np.testing.assert_allclose(got.numpy(), want_jax, rtol=0, atol=1e-5 * top)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=0,
                               atol=1e-5 * top)
    np.testing.assert_allclose(lse.numpy(), twin_lse.numpy(), rtol=0,
                               atol=1e-5 * twin_lse.abs().max().item())
    # the row of one valid key is that key's value row (times its mask)
    one = v[3, 0] * (1.0 if mask is None else mask[3, :, 0][:, None])
    np.testing.assert_allclose(got[3].numpy(), np.broadcast_to(one, got[3]
                                                               .shape),
                               rtol=0, atol=1e-5 * top)


def test_fp32_forward_source_is_the_emulated_design():
    """The kernel the emulation stands for: the CUDA-core forward is gone;
    the fp32 forward streams 64-key tiles (half at D = 128), splits as
    ``split_tf32`` does (hi: add 0x1000, clear the low 13 bits; lo: clear
    them) and multiplies with m16n8k8 tf32 mma.sync, the two small
    products before hi hi."""
    src = SOURCE.read_text()
    helpers = HELPERS.read_text()
    assert "flash_fwd_simt" not in src
    assert '#include "mma_tf32.cuh"' in src
    assert re.search(rf"constexpr int kKeysF32 = {TILE};", src)
    assert "kKeys = D <= 64 ? kKeysF32 : kKeysF32 / 2;" in src
    split = re.search(r"void split_tf32\(.*?\n}\n", helpers, re.S).group(0)
    assert "hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in split
    assert re.search(r"lo = __float_as_uint\(__fsub_rn\(x, __uint_as_float"
                     r"\(hi\)\)\) & 0xffffe000u;", split)
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in helpers
    body = re.search(r"void mma_split\(.*?\n}\n", helpers, re.S).group(0)
    order = re.findall(r"mma_tf32\(d, (\w+), (\w+), (\w+)\)", body)
    assert order == [("alo", "h0", "h1"), ("ahi", "l0", "l1"),
                     ("ahi", "h0", "h1")]


def _jax_vjp(q, k, v, bias, mask, w, scale):
    """out and (dq, dk, dv) of the JAX ``flash_attention`` (interpret
    mode) for the cotangent w."""
    from avsr_tpu.ops.pallas.flash_attention import flash_attention

    def f(q, k, v):
        return flash_attention(
            q, k, v, jnp.asarray(bias), scale=scale, interpret=True,
            dropout_mask=None if mask is None else jnp.asarray(mask))

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(w))]


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_split_tf32_backward_matches_jax_and_twin(d, with_mask):
    """The backward kernels' emulated arithmetic at N=4, T=375 (not a
    multiple of any tile) with ragged keys and a row of one key, with and
    without an explicit pre-scaled dropout mask, fed the emulated
    forward's out and lse as the card feeds them: dq, dk and dv against
    ``jax.vjp`` of the JAX ``flash_attention`` (interpret mode) and
    against ``flash_attention_bwd_plain`` on the same out and lse, each
    within 1e-5 of the gradient's largest entry; delta against the
    twin's. On the head of one valid key P is 1, so dS = dP o M - delta
    and the exact dq and dk are 0: every fp32 evaluation returns the
    rounding of that difference there (the JAX kernel's up to 1.5e-5 of
    the largest entry, the twin's 1.2e-5), so that head's dq and dk are
    held to zero within 2e-5 of the largest entry instead."""
    q, k, v, bias, mask = _case(d, with_mask)
    w = np.random.RandomState(d + 1).randn(*q.shape).astype(np.float32)
    scale = d ** -0.5
    tm = None if mask is None else t(mask)
    out, lse = split_tf32_attention(t(q), t(k), t(v), t(bias), scale, tm)
    got = split_tf32_backward(t(q), t(k), t(v), t(bias), out, t(w), lse,
                              scale, tm)
    _, want_jax = _jax_vjp(q, k, v, bias, mask, w, scale)
    twin = pfa.flash_attention_bwd_plain(t(q), t(k), t(v), t(bias), out,
                                         t(w), lse, scale, dropout_mask=tm)
    for name, g, wj, wt in zip(("dq", "dk", "dv"), got, want_jax, twin):
        top = np.abs(wj).max()
        heads = slice(None) if name == "dv" else slice(0, 3)
        np.testing.assert_allclose(g[heads].numpy(), wj[heads], rtol=0,
                                   atol=1e-5 * top, err_msg=f"{name} vs JAX")
        np.testing.assert_allclose(g[heads].numpy(), wt[heads].numpy(),
                                   rtol=0, atol=1e-5 * top,
                                   err_msg=f"{name} vs twin")
        if name != "dv":
            assert g[3].abs().max() <= 2e-5 * top, name
    np.testing.assert_allclose(got[3].numpy(),
                               pfa.attention_delta_plain(out, t(w)).numpy(),
                               rtol=0, atol=1e-6 * got[3].abs().max().item())


def test_one_tf32_product_would_miss_the_backward_limit(monkeypatch):
    """As for the forward: with one TF32 product a step the emulated
    backward lies past the card's 1e-4 of the largest gradient from the
    twin, so the limits tell the split from plain TF32."""
    q, k, v, bias, _ = _case(64, False)
    w = np.random.RandomState(65).randn(*q.shape).astype(np.float32)
    out, lse = pfa.flash_attention_plain(t(q), t(k), t(v), t(bias), 0.125)
    monkeypatch.setattr(sys.modules[__name__], "split_mm",
                        lambda a, b: tf32_rna(a) @ tf32_rna(b))
    got = split_tf32_backward(t(q), t(k), t(v), t(bias), out, t(w), lse,
                              0.125)
    twin = pfa.flash_attention_bwd_plain(t(q), t(k), t(v), t(bias), out,
                                         t(w), lse, 0.125)
    assert any((g - wt).abs().max() > 1e-4 * wt.abs().max()
               for g, wt in zip(got, twin))


def test_fp32_backward_source_is_the_emulated_design():
    """The kernels the backward emulation stands for: the CUDA-core
    kernels and their launcher are gone; fp32 dq and dkv split as the
    forward does (``split_tf32`` and ``split_a`` of mma_tf32.cuh) and
    multiply with ``mma_split_rows``, which sums each accumulator's three
    TF32 products in ``mma_split``'s order (the two small products before
    hi hi), over the emulated tiles (32 keys, 32 queries; half at D =
    128), with the exact expf; the only fp32 launch is ``launch_tf32``."""
    src = BWD_SOURCE.read_text()
    helpers = HELPERS.read_text()
    assert "_simt" not in src and "launch_simt" not in src
    assert '#include "mma_tf32.cuh"' in src
    for name in ("split_tf32", "split_a", "mma_split_rows"):
        assert f"using avsr::tf32::{name};" in src
    assert "mma.sync" not in src.split("fp32, tensor cores")[1]
    rows = re.search(r"void mma_split_rows\(.*?\n}\n", helpers,
                     re.S).group(0)
    order = re.findall(r"mma_tf32\(d\[i\], (\w+), (\w+)\[i\]\[0\], "
                       r"(\w+)\[i\]\[1\]\)", rows)
    assert order == [("alo", "bhi", "bhi"), ("ahi", "blo", "blo"),
                     ("ahi", "bhi", "bhi")]
    assert re.search(rf"constexpr int kDqKeysF32 = {DQ_TILE};", src)
    assert re.search(rf"constexpr int kDkvQueriesF32 = {DKV_TILE};", src)
    assert "kDqCols = D <= 64 ? kDqKeysF32 : kDqKeysF32 / 2;" in src
    assert re.search(r"kDkvCols =\s+D <= 64 \? kDkvQueriesF32 : "
                     r"kDkvQueriesF32 / 2;", src)
    for kernel in ("flash_bwd_dq_tf32", "flash_bwd_dkv_tf32"):
        body = re.search(rf"\s{kernel}\(.*?\n}}\n", src, re.S).group(0)
        assert "mma_abt_f32" in body and "mma_xb_f32" in body
        assert "prob_f32" in body
    prob = re.search(r"float prob_f32\(.*?\n}\n", src, re.S).group(0)
    assert "expf(" in prob and "exp2_approx" not in prob
    for helper in ("mma_abt_f32", "mma_xb_f32"):
        body = re.search(rf"void {helper}\(.*?\n}}\n", src, re.S).group(0)
        assert "mma_split_rows<" in body and "split_tf32(" in body
    assert "launch_tf32<kDkv, D, true>" in src
