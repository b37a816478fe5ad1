"""The one-launch decoder layer's launch plan and arithmetic, on the CPU.

``csrc/decoder_layer.cu`` walks each of its six GEMVs over the grid in items
of 8-32 output rows x one of the plan's K slices (split-K), and its
LayerNorms combine per-row-group statistics. The plan is Python
(``ops/kernels/decoder_layer.launch_plan``), checked here for covering every
weight element exactly once and for filling the grid at the serving shapes,
with the kernel's limits pinned below (its shared memory and grid come from
the kernel on the card, where tests/test_torch_port_cuda.py checks them).
The kernel's arithmetic (bf16 operands, fp32 sums
by 32-column chunk; fp32 operands in split TF32, product by product in the
kernel's k permutation; the warps' and the slices' partials added in
order, LayerNorm statistics combined over row groups) is emulated in torch
and held against the plain twin and the JAX Pallas kernel in interpret
mode (tests/test_torch_port_layer_fp32.py holds the fp32 path at more
widths and lane counts).
The kernel itself runs on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu_torch.ops.kernels import _build  # noqa: E402
from avsr_tpu_torch.ops.kernels import decoder_layer as pdl  # noqa: E402
from tests.torch_port_common import setup_torch, split_tf32, t  # noqa: E402

NEG = -1.0e30
# the kernel's limits (csrc/decoder_layer.cu): rows of a GEMV item (8 x
# kMaxRowTiles), a stage's K columns (kMaxKsBytes a lane in either dtype)
# and its warps
MAX_ROWS = 32
MAX_KS = {2: 1024, 4: 512}
WARPS = 8


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


# ------------------------------------------------------------ launch plan


def test_constants_are_the_sources():
    """The limits these tests pin are the kernel's source's."""
    src = (_build.CSRC_DIR / "decoder_layer.cu").read_text()
    for line in (f"constexpr int kThreads = {32 * WARPS};",
                 f"constexpr int kMaxRowTiles = {MAX_ROWS // 8};",
                 "constexpr int kMaxRows = 8 * kMaxRowTiles;",
                 f"constexpr int kMaxKsBytes = {2 * MAX_KS[2]};",
                 "return kMaxKsBytes / wsize;",
                 "constexpr int kMaxSmem = 232448;"):
        assert line in src, line
    assert 4 * MAX_KS[4] == 2 * MAX_KS[2]  # kMaxKsBytes a lane in both


def _walk(plan, gemv):
    """{block: [(row group, slice), ...]} of the kernel's grid walk."""
    s = plan.slices[gemv]
    blocks = {}
    for it in range(plan.items[gemv]):
        blocks.setdefault(it % plan.grid, []).append(divmod(it, s))
    return blocks


@pytest.mark.parametrize("n,lanes,c,heads,f", [
    (24, 3, 1024, 16, 3072), (96, 3, 1024, 16, 3072), (39, 3, 64, 1, 128),
    (10, 5, 32, 4, 64), (9, 3, 128, 2, 256), (200, 8, 1024, 16, 3072)])
@pytest.mark.parametrize("wsize", [2, 4])
@pytest.mark.parametrize("grid", [1, 7, 132, 264])
def test_plan_covers_every_weight_once(n, lanes, c, heads, f, wsize, grid):
    """Each GEMV's items, walked over the grid as the kernel walks them,
    cover every (output row, K column) exactly once; an item's rows are a
    multiple of 8 up to kMaxRows, its K slice whole 32-column chunks, and
    no slice is empty; the scratch sizes hold the partials, the statistics
    (row groups of at least 8 columns) and the counters (one a row group of
    8 rows at most). The plan does not depend on the lanes of an utterance,
    the heads or the weights' dtype: the cases keep them to name the
    kernel's shapes."""
    plan = pdl.launch_plan(n, c, f, grid, MAX_ROWS)
    assert plan.grid == grid
    assert plan.gemvs == ((3 * c, c), (c, c), (c, c), (c, c), (f, c), (c, f))
    for gi, (out, k_in) in enumerate(plan.gemvs):
        rows, s, ks = plan.rows[gi], plan.slices[gi], plan.ks[gi]
        assert rows % 8 == 0 and 8 <= rows <= MAX_ROWS
        assert ks % 32 == 0 and s == -(-k_in // ks)
        assert (s - 1) * ks < k_in
        assert plan.items[gi] == -(-out // rows) * s
        cover = np.zeros((out, k_in), int)
        for items in _walk(plan, gi).values():
            for rg, sl in items:
                cover[rg * rows:(rg + 1) * rows, sl * ks:(sl + 1) * ks] += 1
        assert (cover == 1).all()
        if s > 1:
            assert plan.part >= s * out * n
    assert plan.stats == 4 * n * -(-c // 8)
    assert plan.counters == sum(-(-o // 8) for o, _ in plan.gemvs)


@pytest.mark.parametrize("n", [24, 96])
def test_plan_fills_the_card_at_the_serving_shapes(n):
    """At B=8 and B=32 (24 and 96 lanes, C=1024, F=3072) the H100 holds
    132 blocks (one an SM: a block needs more than half of an SM's shared
    memory, checked on the card); every GEMV phase then gives one item to
    at least 96% of them and none takes two. These are the measured plans
    (PERF.md section 6): items of 24 rows for the 3C- and F-row GEMVs and
    8 for the C-row ones, no split-K."""
    plan = pdl.launch_plan(n, 1024, 3072, 132, MAX_ROWS)
    for gi in range(6):
        blocks = _walk(plan, gi)
        assert len(blocks) >= 0.96 * 132, (gi, plan.rows, plan.slices)
        assert max(len(v) for v in blocks.values()) == 1
    assert plan.rows == (24, 8, 8, 8, 24, 8)
    assert plan.slices == (1,) * 6


@pytest.mark.parametrize("c,f,grid", [(128, 256, 132), (64, 128, 660),
                                      (32, 64, 396)])
def test_plan_splits_k_where_rows_leave_the_grid_idle(c, f, grid):
    """A narrow layer's GEMVs, whose 8-row items would leave half of the
    grid idle, are cut into K slices: the items then fill at least half of
    the grid and never outnumber it."""
    plan = pdl.launch_plan(9, c, f, grid, MAX_ROWS)
    for (out, k_in), s, items in zip(plan.gemvs, plan.slices, plan.items):
        assert s > 1 or k_in <= 32
        assert grid // 2 < items <= grid or s == -(-k_in // 32)


def test_scratch_matches_the_plan():
    """layer_scratch holds the plan's statistics and counters (zero); the
    partials grow to the plan's size at the first launch."""
    n, c, f = 24, 64, 128
    sc = pdl.layer_scratch(n, c, f, "cpu")
    plan = pdl.launch_plan(n, c, f, 132, MAX_ROWS)
    assert sc.stats.numel() == plan.stats
    assert sc.counters.dtype == torch.int32
    assert sc.counters.numel() == plan.counters
    assert not sc.counters.any()
    assert sc.opnd.shape == (n, max(c, f))


# -------------------------------------------------- the kernel's arithmetic


def tf32_column(p: int, k: int) -> int:
    """The fp32 GEMV's k permutation: the physical column, within a
    32-column chunk, that logical k (0-7) of the chunk's k8 product p (0-3)
    takes on both operands (lane t reads columns 8t..8t+7; product 2h + j
    takes 8t + 4h + 2j as k = t and the next as k = t + 4)."""
    return 8 * (k % 4) + 2 * p + k // 4


TF32_COLUMNS = [[tf32_column(p, k) for k in range(8)] for p in range(4)]


def tf32_chunks(acc, h, w, products=split_tf32):
    """A warp's products over the 32-column chunks of h (N, K') and w (O,
    K'), zeros past K', added into acc in the kernel's order: each chunk's
    four k8 products in turn, each as lo_h hi_w, hi_h lo_w, then hi_h hi_w
    (``mma_split``'s order; ``products`` splits an operand into (hi,
    lo))."""
    pad = -h.shape[1] % 32
    h = torch.nn.functional.pad(h, (0, pad))
    w = torch.nn.functional.pad(w, (0, pad))
    hh, hl = products(h)
    wh, wl = products(w)
    for c0 in range(0, h.shape[1], 32):
        for cols in TF32_COLUMNS:
            i = [c0 + k for k in cols]
            acc = acc + hl[:, i] @ wh[:, i].T
            acc = acc + hh[:, i] @ wl[:, i].T
            acc = acc + hh[:, i] @ wh[:, i].T
    return acc


def emulate_gemv(h, w, bias, ks, wsize, products=split_tf32):
    """The kernel's GEMV in torch: h (N, K) and w (O, K) hold values of the
    weight dtype in fp32. Each K slice of ``ks`` columns is staged
    ``MAX_KS`` columns at a time; each stage's 32-column chunks split over
    the 8 warps; a warp's fp32 sum runs over its chunks of every stage
    (bf16: the chunks' products; fp32: ``tf32_chunks``); the warps' sums
    are added in order, then the slices' in order, then the bias."""
    out, k_in = w.shape
    most = MAX_KS[wsize]
    total = torch.zeros(h.shape[0], out)
    for s in range(-(-k_in // ks)):
        k0, k1 = s * ks, min(k_in, (s + 1) * ks)
        warps = [torch.zeros(h.shape[0], out) for _ in range(WARPS)]
        for kb in range(k0, k1, most):
            ke = min(k1, kb + most)
            per = -(-(-(-(ke - kb) // 32)) // WARPS)
            for wi in range(WARPS):
                c0 = min(ke, kb + wi * per * 32)
                c1 = min(ke, c0 + per * 32)
                if c1 > c0 and wsize == 4:
                    warps[wi] = tf32_chunks(warps[wi], h[:, c0:c1],
                                            w[:, c0:c1], products)
                elif c1 > c0:
                    warps[wi] = warps[wi] + h[:, c0:c1] @ w[:, c0:c1].T
        part = torch.zeros(h.shape[0], out)
        for wp in warps:
            part = part + wp
        total = total + part
    return total + bias


def emulate_ln(v, g, b, groups=None):
    """The kernel's LayerNorm: LN1 from the row's mean and centred
    variance; LN2 and LN3 from each row group's (``groups`` columns: the
    residual GEMV's item rows) sum s and centred sum of squares m, combined
    pairwise once the mean is known: sum m + n_g (s / n_g - mean)^2."""
    c = v.shape[-1]
    if groups is None:
        mean = v.mean(dim=-1, keepdim=True)
        var = ((v - mean) ** 2).mean(dim=-1, keepdim=True)
    else:
        parts = [v[:, c0:c0 + groups] for c0 in range(0, c, groups)]
        sums = [p.sum(dim=-1, keepdim=True) for p in parts]
        mean = sum(sums) / c
        m2 = 0.0
        for p, s in zip(parts, sums):
            ng = p.shape[-1]
            m2 = m2 + ((p - s / ng) ** 2).sum(dim=-1, keepdim=True)
            m2 = m2 + ng * (s / ng - mean) ** 2
        var = m2 / c
    return (v - mean) * torch.rsqrt(var + pdl.LN_EPS) * g + b


@pytest.mark.parametrize("groups", [8, 24, 32])
@pytest.mark.parametrize("spread", [1.0, 1e-3])
def test_grouped_layernorm_holds_at_an_offset(groups, spread):
    """LN2's and LN3's statistics combined over row groups, as the kernel
    combines them, on fp32 rows whose mean (30) is 30 or 30000 times their
    spread, one row constant: finite, and within 8 times the twin's own
    error (its two-pass LayerNorm in fp32) against a float64 evaluation,
    plus 1e-5. A one-pass combine (sum s^2 / n_g - sum s * mean) loses the
    variance here: 7.4e-4 off at spread 1, negative and NaN at 1e-3."""
    rng = np.random.RandomState(3)
    c = 1024
    v = 30.0 + spread * rng.randn(6, c)
    v[-1] = 30.0
    x = torch.from_numpy(v).float()
    g = t(1.0 + 0.1 * rng.randn(c))
    b = t(0.1 * rng.randn(c))
    xd = x.double()
    mean = xd.mean(dim=-1, keepdim=True)
    var = ((xd - mean) ** 2).mean(dim=-1, keepdim=True)
    ref = (xd - mean) * torch.rsqrt(var + pdl.LN_EPS) * g.double() + b.double()
    got = emulate_ln(x, g, b, groups)
    twin = emulate_ln(x, g, b)
    assert torch.isfinite(got).all()
    err = (got.double() - ref).abs().max().item()
    twin_err = (twin.double() - ref).abs().max().item()
    assert err <= 8 * twin_err + 1e-5, (err, twin_err)


MMA_DH = 64  # csrc/decoder_layer.cu kMmaDh: the heads attended on mma
DH_COLUMNS = [32 * hf + tf32_column(p, k) for hf in range(MMA_DH // 32)
              for p in range(4) for k in range(8)]


def split_scores(q, keys, products):
    """q.k as the fp32 kernel forms it: K (..., R, dh) as the A operand,
    q (..., K, dh) as B, in split TF32, the k8 products over each 32 of
    the head's dims in the GEMV's permutation, in turn."""
    kh, kl = products(keys)
    qh, ql = products(q)
    acc = torch.zeros(*q.shape[:-1], keys.shape[-2])
    for i in range(0, MMA_DH, 8):
        d = DH_COLUMNS[i:i + 8]
        for a, b in ((kl, qh), (kh, ql), (kh, qh)):
            acc = acc + torch.einsum("...kd,...rd->...kr", b[..., d],
                                     a[..., d])
    return acc


def split_pv(p, values, tile, r_all, products):
    """P.V as the fp32 kernel forms it: V^T (16 dims x 8 rows) as the A
    operand, P as B, in split TF32 over k8 steps of 8 consecutive rows;
    with one query tile (<= 8 lanes) each of the 8 warps takes the 16-row
    groups warp, warp + 8, ... of every tile and the warps' sums add in
    warp order; with more, two row halves (groups h, h + 2, ...), the
    second half's sum added to the first's."""
    ph, pl = products(p)
    vh, vl = products(values)
    lanes = p.shape[-2]
    groups, first, step = ((8, 16, 128) if lanes <= 8 else (2, 16, 32))
    tiles = [(r0, min(r0 + tile, r_all)) for r0 in range(0, r_all, tile)]
    parts = []
    for w in range(groups):
        acc = torch.zeros(*p.shape[:-1], values.shape[-1])
        for r0, r1 in tiles:
            for t16 in range(w * first, r1 - r0, step):
                for s8 in (0, 8):
                    i = list(range(r0 + t16 + s8, min(r0 + t16 + s8 + 8, r1)))
                    if not i:
                        continue
                    for a, b in ((vl, ph), (vh, pl), (vh, ph)):
                        acc = acc + torch.einsum(
                            "...kr,...rd->...kd", b[..., i], a[..., i, :])
        parts.append(acc)
    if groups == 2:
        return parts[0] + parts[1]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def emulate_attention(q, keys, values, bias, cur, vn, tile, kd,
                      products=split_tf32):
    """The kernel's ``attend`` over R stored rows (fp32 tensors (..., K,
    dh) queries, (..., R, dh) keys and values, (..., K, R) bias; with the
    fresh score ``cur`` (..., K) and value ``vn`` (..., K, dh), or None):
    one pass where R <= ``tile``, else two over tiles of ``tile`` rows;
    each pass's statistics taken by 8 warps over even row ranges and folded
    into the joint (max, shifted sum) in warp (and tile) order, starting
    from the fresh score; p and the fresh row's share rounded to ``kd``;
    P.V in fp32, tile by tile. With an fp32 cache and 64-wide heads q.k
    and P.V as the kernel's split-TF32 mma path forms them
    (``split_scores``, ``split_pv``; ``products`` splits an operand)."""
    r_all = keys.shape[-2]
    mma = kd == torch.float32 and q.shape[-1] == MMA_DH
    if mma:
        scores = split_scores(q, keys, products) + bias
    else:
        scores = torch.einsum("...kd,...rd->...kr", q, keys) + bias
    m = cur if cur is not None else torch.full(q.shape[:-1], float("-inf"))
    den = torch.ones_like(m) if cur is not None else torch.zeros_like(m)
    spans = ([(0, r_all)] if r_all <= tile else
             [(r0, min(r0 + tile, r_all)) for r0 in range(0, r_all, tile)])
    for r0, r1 in spans:
        per = -(-(r1 - r0) // 8)
        for w in range(8):
            part = scores[..., r0 + w * per:min(r0 + (w + 1) * per, r1)]
            if part.shape[-1] == 0:
                m_w = torch.full_like(m, float("-inf"))
                l_w = torch.zeros_like(den)
            else:
                m_w = part.amax(dim=-1)
                l_w = torch.exp(part - m_w.clamp_min(-3.0e38)[..., None]).sum(-1)
            mm = torch.maximum(m, m_w)
            safe = mm.clamp_min(-3.0e38)
            den = den * torch.exp(m - safe) + l_w * torch.exp(m_w - safe)
            m = mm
    den = den.clamp_min(1e-30)
    p = (torch.exp(scores - m[..., None]) / den[..., None]).to(kd).float()
    if mma:
        out = split_pv(p, values, tile, r_all, products)
    else:
        out = torch.zeros(*q.shape)
        for r0, r1 in ([(r0, min(r0 + tile, r_all))
                        for r0 in range(0, r_all, tile)] or [(0, 0)]):
            out = out + torch.einsum("...kr,...rd->...kd", p[..., r0:r1],
                                     values[..., r0:r1, :])
    if cur is not None:
        pc = (torch.exp(cur - m) / den).to(kd).float()
        out = out + pc[..., None] * vn
    return out


def emulate_layer(pos, x, kv_cache, src_k, src_v, mem_bias, lane_bias,
                  packed, lanes, heads, plan, tile=None, products=split_tf32):
    """``decoder_layer_step`` with the kernel's GEMVs (fp32 ones split by
    ``products``) and LayerNorms;
    the attention as the twin's (the kernel's takes the same rounding
    points, its fp32 sums in other orders), or, with ``tile``, in the
    kernel's order (``emulate_attention``: the rows s < min(pos, S) of
    every lane, two passes where they exceed the tile); returns (x_out,
    the K|V row)."""
    n, s_max, c2 = kv_cache.shape
    c = c2 // 2
    b, dh = n // lanes, c // heads
    wd, kd = packed.w_qkv.dtype, kv_cache.dtype
    wsize = torch.empty(0, dtype=wd).element_size()
    def gemv(i, h, w, bias):
        return emulate_gemv(h, w, bias, plan.ks[i], wsize, products)

    p = [v.float() for v in packed]
    (ln_w, ln_b, w_qkv, b_qkv, w_out, b_out, w_q2, b_q2, w_out2, b_out2,
     w_1, b_1, w_2, b_2) = p
    scale = float(torch.tensor(dh ** -0.5, dtype=torch.float32))

    def rnd(v, dt):
        return v.to(dt).float()

    xf = x.float()
    qkv = gemv(0, rnd(emulate_ln(xf, ln_w[0], ln_b[0]), wd), w_qkv, b_qkv)
    q = rnd(rnd(qkv[:, :c] * scale, wd), kd).view(b, lanes, heads, dh)
    k_new = rnd(qkv[:, c:2 * c], kd).view(b, lanes, heads, dh)
    v_new = rnd(qkv[:, 2 * c:], kd).view(b, lanes, heads, dh)
    kv = kv_cache.float().view(b, lanes, s_max, 2, heads, dh)
    cur = torch.einsum("bkhd,bkhd->bhk", k_new, q)
    if tile is not None:
        s_lim = min(pos, s_max)
        rows = kv[:, :, :s_lim].permute(0, 4, 1, 2, 3, 5).reshape(
            b, heads, lanes * s_lim, 2, dh)
        bias = lane_bias[:, :, :s_lim].permute(0, 1, 3, 2).reshape(
            b, 1, lanes, lanes * s_lim)
        o = emulate_attention(q.permute(0, 2, 1, 3), rows[..., 0, :],
                              rows[..., 1, :], bias, cur,
                              v_new.permute(0, 2, 1, 3), tile, kd, products)
        o = o.permute(0, 2, 1, 3)
    else:
        scores = torch.einsum("bkhd,bjshd->bhkjs", q, kv[:, :, :, 0])
        scores = scores + lane_bias.permute(0, 1, 3, 2)[:, None]
        if pos < s_max:
            scores[..., pos] += NEG
        flat = scores.reshape(b, heads, lanes, lanes * s_max)
        m = torch.maximum(flat.amax(dim=-1), cur)
        pr, pc = torch.exp(flat - m[..., None]), torch.exp(cur - m)
        den = (pr.sum(dim=-1) + pc).clamp_min(1e-30)
        pr = rnd(pr / den[..., None], kd).view(b, heads, lanes, lanes, s_max)
        pc = rnd(pc / den, kd)
        o = torch.einsum("bhkjs,bjshd->bkhd", pr, kv[:, :, :, 1])
        o = o + pc.permute(0, 2, 1)[..., None] * v_new
    xf = xf + gemv(1, rnd(o.reshape(n, c), wd), w_out, b_out)
    q2 = gemv(2, rnd(emulate_ln(xf, ln_w[1], ln_b[1], plan.rows[1]), wd),
              w_q2, b_q2) * scale
    q2 = rnd(rnd(q2, wd), kd).view(b, lanes, heads, dh)
    sk = src_k.float().view(b, -1, heads, dh)
    sv = src_v.float().view(b, -1, heads, dh)
    if tile is not None:
        o2 = emulate_attention(
            q2.permute(0, 2, 1, 3), sk.permute(0, 2, 1, 3),
            sv.permute(0, 2, 1, 3), mem_bias[:, None, None, :], None, None,
            tile, kd, products).permute(0, 2, 1, 3)
    else:
        s2 = torch.einsum("bkhd,bshd->bhks", q2, sk) + mem_bias[:, None,
                                                                 None, :]
        p2 = torch.exp(s2 - s2.amax(dim=-1, keepdim=True))
        p2 = rnd(p2 / p2.sum(dim=-1, keepdim=True).clamp_min(1e-30), kd)
        o2 = torch.einsum("bhks,bshd->bkhd", p2, sv)
    xf = xf + gemv(3, rnd(o2.reshape(n, c), wd), w_out2, b_out2)
    hid = rnd(torch.relu(gemv(
        4, rnd(emulate_ln(xf, ln_w[2], ln_b[2], plan.rows[3]), wd), w_1,
        b_1)), wd)
    xf = xf + gemv(5, hid, w_2, b_2)
    row = torch.cat([k_new, v_new], dim=2).reshape(n, 2 * c)
    return xf.to(x.dtype), row.to(kd)


BE, KE, SE, S_ENC, CE, HE, FE = 3, 3, 16, 11, 128, 2, 256


def _case(pos, seed, dtype, lanes=KE, c=CE, heads=HE, f=FE):
    """A layer of random weights (LN scales around 1) and one step's
    inputs at C=128, F=256, two 64-wide heads (or ``c``, ``heads``,
    ``f``), B=3, K=3 (or ``lanes``): the beam's contract (rows past pos
    masked on every lane, this step's row each lane's own), utterance 1's
    last 3 source rows padded."""
    from avsr_tpu_torch.models.decoder import DecoderLayer

    rng = np.random.RandomState(seed)
    layer = DecoderLayer(c, heads, f)
    with torch.no_grad():
        for name, prm in layer.named_parameters():
            if "norm" in name:
                base = 1.0 if name.endswith("weight") else 0.0
                prm.copy_(t(base + 0.1 * rng.randn(*prm.shape)))
            else:
                prm.copy_(t(rng.randn(*prm.shape) / np.sqrt(prm.shape[-1])))
    packed = pdl.pack_layer_params(layer, dtype)
    n = BE * lanes
    x = t(rng.randn(n, c)).to(dtype)
    kv = t(rng.randn(n, SE, 2 * c)).to(dtype)
    src_k, src_v = (t(rng.randn(BE, S_ENC, c)).to(dtype) for _ in range(2))
    mem_bias = torch.zeros(BE, S_ENC)
    mem_bias[1, -3:] = NEG
    anc = rng.randint(0, lanes, size=(SE, BE, lanes))
    anc[min(pos, SE - 1)] = np.arange(lanes)
    valid = (np.arange(SE) <= pos)[:, None, None, None] & (
        anc[..., None] == np.arange(lanes))
    lane_bias = t(np.where(valid.transpose(1, 2, 0, 3), 0.0, NEG))
    return layer, packed, (x, kv, src_k, src_v, mem_bias, lane_bias.float())


def _jax_step(pos, layer, args, dtype, lanes=KE, heads=HE):
    from avsr_tpu.ops.pallas import decoder_layer as jdl

    tree = {}
    for name, prm in layer.named_parameters():
        *path, leaf = name.replace("feed_forward.", "").split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        value = prm.detach().numpy()
        if path[0].startswith("norm"):
            node["scale" if leaf == "weight" else "bias"] = value
        else:
            node["kernel" if leaf == "weight" else "bias"] = (
                value.T if leaf == "weight" else value)
    jd = jnp.dtype(str(dtype).replace("torch.", ""))
    x, kv, src_k, src_v, mem_bias, lane_bias = (
        jnp.asarray(a.float().numpy()) for a in args)
    out, cache = jdl.decoder_layer_step(
        jnp.asarray(pos, jnp.int32), x.astype(jd), kv.astype(jd),
        src_k.astype(jd), src_v.astype(jd), mem_bias, lane_bias,
        jdl.pack_layer_params(tree, jd), lanes=lanes, heads=heads,
        interpret=True)
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(cache.astype(jnp.float32))[:, min(pos, SE - 1)])


def _plan(items):
    """The arithmetic test's launch plan: as planned over 1 or 132 blocks,
    or with split-K forced on every GEMV."""
    plan = pdl.launch_plan(BE * KE, CE, FE,
                           1 if items == "one block" else 132, MAX_ROWS)
    if items == "split-K":
        ks = tuple(pdl.slice_cols(k_in, s) for (_, k_in), s in
                   zip(plan.gemvs, (2, 4, 3, 2, 4, 8)))
        plan = plan._replace(
            rows=(8, 16, 24, 32, 8, 16), ks=ks,
            slices=tuple(-(-k_in // k) for (_, k_in), k in zip(plan.gemvs,
                                                              ks)))
    return plan


@pytest.mark.parametrize("pos", [0, 7, SE + 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("items", ["one block", "132 blocks", "split-K"])
def test_kernel_arithmetic_matches_plain_and_jax(pos, dtype, tol, items):
    """The emulated kernel (its items as planned over 1 block: 32 rows, and
    over 132: 8 rows, or forced to rows of 8-32 with 2-8 K slices) against
    the twin and JAX's ``decoder_layer_step`` (interpret): x_out and the
    written row within tol x |max| (fp32 2e-5: split TF32, ~2^-21 of a
    product dropped, and sums in another order; bf16 2e-2: a bf16 ulp of
    the rounded operands), as the card holds the kernel. At pos = S+3 all S stored rows and the fresh one are
    attended."""
    layer, packed, args = _case(pos, pos + 1, dtype)
    plan = _plan(items)
    got_x, got_row = emulate_layer(pos, *args, packed, KE, HE, plan)
    want_x, want_kv = pdl.decoder_layer_step_plain(
        pos, *(a.clone() for a in args), packed, KE, HE)
    jax_x, jax_row = _jax_step(pos, layer, args, dtype)
    want_row = want_kv[:, min(pos, SE - 1)]
    for name, got, want in (("x_out", got_x, want_x.float().numpy()),
                            ("row", got_row, want_row.float().numpy()),
                            ("x_out vs JAX", got_x, jax_x),
                            ("row vs JAX", got_row, jax_row)):
        got = got.float().numpy()
        err = np.abs(got - want).max()
        assert err <= tol * np.abs(want).max(), f"{name}: {err:.3e}"


@pytest.mark.parametrize("lanes,tile", [(3, 560), (10, 16), (22, 32),
                                        (32, 48)])
@pytest.mark.parametrize("pos", [0, 7, SE + 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_wide_beam_attention_matches_plain_and_jax(lanes, tile, pos, dtype,
                                                   tol):
    """ROADMAP C30: the kernel's attention order (``emulate_attention``),
    one pass (3 lanes) or two over tiles of ``tile`` rows (10, 22 and 32
    lanes: the scores of every lane's rows need not fit a block), inside
    the emulated layer, against the twin and JAX's ``decoder_layer_step``
    (interpret) at the same lanes: x_out and the written row within tol x
    |max|, as test_kernel_arithmetic_matches_plain_and_jax holds them."""
    layer, packed, args = _case(pos, pos + lanes, dtype, lanes)
    plan = pdl.launch_plan(BE * lanes, CE, FE, 132, MAX_ROWS)
    got_x, got_row = emulate_layer(pos, *args, packed, lanes, HE, plan,
                                   tile=tile)
    want_x, want_kv = pdl.decoder_layer_step_plain(
        pos, *(a.clone() for a in args), packed, lanes, HE)
    jax_x, jax_row = _jax_step(pos, layer, args, dtype, lanes)
    want_row = want_kv[:, min(pos, SE - 1)]
    for name, got, want in (("x_out", got_x, want_x.float().numpy()),
                            ("row", got_row, want_row.float().numpy()),
                            ("x_out vs JAX", got_x, jax_x),
                            ("row vs JAX", got_row, jax_row)):
        got = got.float().numpy()
        err = np.abs(got - want).max()
        assert err <= tol * np.abs(want).max(), f"{name}: {err:.3e}"


def test_arithmetic_cases_reach_split_k():
    """The arithmetic test's plans hold 32-row and 8-row items and, forced,
    several K slices (the plan is the same in bf16 and in fp32)."""
    assert set(_plan("one block").rows) == {32}
    assert set(_plan("132 blocks").rows) == {8}
    assert min(_plan("split-K").slices) > 1
