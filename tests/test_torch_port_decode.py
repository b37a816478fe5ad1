"""The beam's two per-step kernels, as far as the CPU reaches them.

``decode_attention`` (csrc/decode_attention.cu) splits one (utterance,
head)'s rows over a thread-block cluster; its launch plan is Python
(``launch_plan``), checked here for every row falling in exactly one rank.
Its split arithmetic (per-rank (m, l) combined in rank order, P rounded to
the cache dtype after normalising, per-rank partial P.V summed in rank
order) and ``cumlogsumexp``'s chunked parallel scan (csrc/scan_logsumexp.cu)
are emulated in torch and held against the plain twins and the JAX Pallas
kernels in interpret mode. The kernels themselves run on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu_torch.ops.kernels import _build  # noqa: E402
from avsr_tpu_torch.ops.kernels import decode_attention as pda  # noqa: E402
from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl  # noqa: E402
from tests.torch_port_common import decode_case, setup_torch, t  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


# ------------------------------------------------------- B2: launch plan


def test_plan_constants_are_the_kernels():
    """The plan's block size and shared-memory limit are the source's."""
    src = (_build.CSRC_DIR / "decode_attention.cu").read_text()
    assert f"constexpr int kThreads = {pda.THREADS};" in src
    assert f"constexpr int kMaxSmem = {pda.SMEM_MAX};" in src
    assert pda.SMEM_MAX == 227 * 1024


@pytest.mark.parametrize("lanes", [*range(1, 9), 9, 22, 40, 64, 100])
def test_plan_covers_every_row_once(lanes):
    """For every S, batch and cache dtype one launch, and at every pos
    (pos >= S clamps to S-1) the kernel's even split of its live rows:
    each (j, s <= pos_c) row lies in exactly one rank and, within it, in
    exactly one chunk, row pos_c of each lane has exactly one owner, every
    lane lies in one query group of at most GROUP_LANES, the grid is
    (H*G, B) with G a cluster size, the chunks hold whole tiles where a
    rank takes more than one, and a block's shared memory stays within 227
    KB."""
    heads, dh = 16, 64
    for s_max in (1, 64, 192, 1000):
        for b, esize in ((8, 2), (32, 2), (8, 4), (1, 4)):
            # one launch for every step: sized for all lanes * S rows
            plan = pda.launch_plan(b, lanes, heads, dh, s_max, esize)
            assert plan.rows == lanes * s_max
            for pos in (0, 1, s_max - 1, s_max + 58):
                pos_c = min(pos, s_max - 1)
                rows = lanes * (pos_c + 1)
                live = plan.at(pos)  # the kernel's split of the live rows
                assert plan.cluster in (1, *pda.CLUSTER_SIZES)
                assert plan.grid == (heads * plan.cluster, b)
                assert plan.grid[0] % plan.cluster == 0
                assert live.rows == rows
                assert plan.group_lanes <= pda.GROUP_LANES
                assert (plan.groups - 1) * plan.group_lanes < lanes <= (
                    plan.groups * plan.group_lanes)
                assert live.rows_per_rank % 4 == 0
                assert live.rows_per_rank <= plan.rows_per_rank
                owner = np.zeros(rows, int)
                for r in range(plan.cluster):
                    got = live.rank_rows(r)
                    assert len(got) <= live.rows_per_rank
                    owner[list(got)] += 1
                    chunks = live.rank_chunks(r)
                    assert sum(len(ch) for ch in chunks) == len(got)
                    assert all(len(ch) <= plan.chunk for ch in chunks)
                assert (owner == 1).all()
                for j in range(lanes):  # row (pos_c, j) = pos_c * K + j
                    holders = [r for r in range(plan.cluster)
                               if pos_c * lanes + j in live.rank_rows(r)]
                    assert len(holders) == 1
                assert 1 <= plan.tile <= plan.rows_per_rank
                assert plan.rows_per_rank % 4 == 0
                assert plan.chunk == plan.rows_per_rank or (
                    plan.chunk % plan.tile == 0
                    and plan.chunk < plan.rows_per_rank)
                assert plan.smem == pda.smem_bytes(plan.group_lanes, dh,
                                                   esize, plan.chunk,
                                                   plan.tile)
                assert plan.smem <= 227 * 1024


def test_plan_fills_the_card_and_can_be_forced():
    """G is CLUSTER (2, the fastest measured at B=8, H=16) while the
    (utterance, head) pairs fill the card's SMs less than twice, else 1
    (the fastest at B=32), raised only where a rank's scores would not fit
    one pass; a forced G is kept; two blocks share an SM where a tile of PAIR_TILE
    rows fits beside the scores; a shape whose scores do not fit at any G
    takes two passes over chunks of whole tiles."""
    assert pda.CLUSTER == 2
    for b in (1, 2, 4, 8, 16, 32):
        assert pda.launch_plan(b, 3, 16, 64, 192, 2).cluster == (
            1 if b * 16 >= 2 * pda.SMS else 2)
    for g in (1, 2, 4, 8):
        plan = pda.launch_plan(8, 3, 16, 64, 192, 2, g)
        assert plan.cluster == g and plan.grid == (16 * g, 8)
    # the serving chunk fits one stage buffer: K and V loads go out at once
    plan = pda.launch_plan(8, 3, 16, 64, 192, 2)
    assert plan.tile == plan.rows_per_rank == plan.chunk == 288
    assert plan.smem <= pda.PAIR_SMEM
    # phase 8's beam of 22 (B=32, S=128): one pass over all 2816 rows at
    # G=4, two blocks an SM, in tiles; a rank's rows a multiple of 4 (its
    # bias copied 16 bytes at a time), at pos 74 an even share of 1650
    plan = pda.launch_plan(32, 22, 16, 64, 128, 2)
    assert plan.cluster == 4 and plan.chunk == plan.rows_per_rank == 704
    assert pda.PAIR_TILE <= plan.tile < 704 and plan.smem <= pda.PAIR_SMEM
    assert plan.at(74).rows == 1650 and plan.at(74).rows_per_rank == 416
    # a long cache tiles the chunk instead
    plan = pda.launch_plan(8, 8, 16, 128, 1000, 4)
    assert plan.tile < plan.rows_per_rank
    # beam 64 over a full 192-row cache, and a cache too long for any G:
    # two passes
    for args in ((32, 64, 16, 64, 192, 2), (1, 8, 1, 128, 200000, 4)):
        plan = pda.launch_plan(*args)
        assert plan.cluster == 8 and plan.chunk < plan.rows_per_rank
        assert plan.chunk % plan.tile == 0 and plan.smem <= pda.SMEM_MAX


# ------------------------------------------- B2: the split's arithmetic


def _combine(m, s, m2, s2):
    """The kernels' (max, shifted sum) monoid with its -3e38 guard."""
    mm = torch.maximum(m, m2)
    safe = mm.clamp_min(-3.0e38)
    return mm, s * torch.exp(m - safe) + s2 * torch.exp(m2 - safe)


def emulate_decode(pos, q, kv_cache, lane_bias, lanes, heads, kv_row, plan):
    """csrc/decode_attention.cu's arithmetic, rank by rank, in torch: rows
    (s <= pos_c, j) in the kernel's order, row pos_c taken from kv_row;
    per-rank (m, l) combined in rank order; P normalised, then rounded to
    the cache dtype; per-rank partial P.V summed in rank order."""
    n, s_max, c2 = kv_cache.shape
    c, b = c2 // 2, n // lanes
    dh = c // heads
    cd = kv_cache.dtype
    pos_c = min(pos, s_max - 1)
    kv = kv_cache.view(b, lanes, s_max, 2, heads, dh)[:, :, :pos_c + 1]
    kv = kv.clone()
    kv[:, :, pos_c] = kv_row.to(cd).view(b, lanes, 2, heads, dh)
    # rows s-major: row r = s * K + j
    kv = kv.float().transpose(1, 2).reshape(b, plan.rows, 2, heads, dh)
    qq = q.to(cd).float().view(b, lanes, heads, dh)
    bias = lane_bias[:, :, :pos_c + 1]  # (B, K, s, J)
    scores = (torch.einsum("bkhd,brhd->bhkr", qq, kv[:, :, 0])
              + bias.reshape(b, 1, lanes, plan.rows))
    m = torch.full(scores.shape[:-1], float("-inf"))
    den = torch.zeros(scores.shape[:-1])
    for r in range(plan.cluster):
        rows = plan.rank_rows(r)
        if len(rows):
            part = scores[..., rows.start:rows.stop]
            m_r = part.amax(dim=-1)
            l_r = torch.exp(part - m_r.clamp_min(-3.0e38)[..., None]).sum(-1)
        else:
            m_r, l_r = torch.full_like(m, float("-inf")), torch.zeros_like(den)
        m, den = _combine(m, den, m_r, l_r)
    p = torch.exp(scores - m[..., None]) / den.clamp_min(1e-30)[..., None]
    p = p.to(cd).float()
    out = torch.zeros(b, heads, lanes, dh)
    for r in range(plan.cluster):
        rows = plan.rank_rows(r)
        out = out + torch.einsum("bhkr,brhd->bhkd",
                                 p[..., rows.start:rows.stop],
                                 kv[:, rows.start:rows.stop, 1])
    return out.permute(0, 2, 1, 3).reshape(n, c).to(q.dtype)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,cluster", [(0, 8), (0, 2), (1, 4), (37, 8),
                                         (63, 2), (90, 4), (40, 1)])
def test_split_arithmetic_matches_plain_and_jax(pos, cluster, cache_dtype):
    """The emulated split against the twin and JAX's ``decode_attention``
    (resident v3, interpret): fp32 within 2e-5 (summation order), a bf16
    cache within 1e-4 (an fp32-order flip of a rounded p would be ~4e-3;
    measured at most 1.2e-7). S = 64, B = 2, K = 3; at pos 0 most ranks
    hold no row and contribute (-inf, 0)."""
    from avsr_tpu.ops.pallas.decode_attention import decode_attention

    b, k, s_max, heads, dh = 2, 3, 64, 4, 32
    q, kv, row, bias = decode_case(pos, b, k, s_max, heads, dh, pos,
                                   q_scale=dh ** -0.5)
    cd = getattr(torch, cache_dtype)
    plan = pda.launch_plan(b, k, heads, dh, s_max,
                           torch.empty(0, dtype=cd).element_size(),
                           cluster).at(pos)
    if pos == 0:
        assert sum(len(plan.rank_rows(r)) == 0
                   for r in range(plan.cluster)) >= plan.cluster - k
    cache = t(kv).to(cd)
    got = emulate_decode(pos, t(q), cache, t(bias), k, heads, t(row), plan)
    want, want_kv = pda.decode_attention_plain(pos, t(q), cache.clone(),
                                               t(bias), k, heads, t(row))
    jkv = jnp.asarray(kv).astype(jnp.bfloat16 if cache_dtype == "bfloat16"
                                 else jnp.float32)
    jout, jkv_out = decode_attention(
        jnp.asarray(pos), jnp.asarray(q), jkv, jnp.asarray(bias), lanes=k,
        heads=heads, kv_row=jnp.asarray(row), resident=True)
    tol = 2e-5 if cache_dtype == "float32" else 1e-4
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), atol=tol,
                               rtol=0)
    np.testing.assert_array_equal(
        want_kv.float().numpy(), np.asarray(jkv_out.astype(jnp.float32)))


# ------------------------------------------ B2: the output bound (C27)


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,s_max", [(0, 64), (37, 64), (63, 64),
                                       (80, 64), (150, 192)])
def test_jax_kernel_and_twin_within_the_output_bound(qdtype, pos, s_max):
    """JAX's ``decode_attention`` (resident v3, interpret) and the fp32 twin
    lie within ``output_bound`` of each other element by element, with a
    bf16 cache, q in bf16 (the output rounded, as the beam serves) and in
    fp32 (unrounded): B=2, K=3, H=4, dh=64, the queries scaled as the
    decoder scales them. The bound is no looser than it need be: it stays
    within a few output ulps plus the p flips it counts."""
    from avsr_tpu.ops.pallas.decode_attention import decode_attention

    b, k, heads, dh = 2, 3, 4, 64
    q, kv, row, bias = decode_case(pos + s_max, b, k, s_max, heads, dh, pos,
                                   q_scale=dh ** -0.5)
    td = getattr(torch, qdtype)
    jd = jnp.bfloat16 if qdtype == "bfloat16" else jnp.float32
    cache = t(kv).to(torch.bfloat16)
    tq = t(q).to(td)
    want, _ = pda.decode_attention_plain(pos, tq, cache.clone(), t(bias), k,
                                         heads, t(row))
    jout, _ = decode_attention(
        jnp.asarray(pos), jnp.asarray(q).astype(jd),
        jnp.asarray(kv).astype(jnp.bfloat16), jnp.asarray(bias), lanes=k,
        heads=heads, kv_row=jnp.asarray(row).astype(jnp.bfloat16),
        resident=True)
    bound = pda.output_bound(pos, tq, cache, t(bias), k, heads, t(row))
    got = torch.from_numpy(np.asarray(jout.astype(jnp.float32)))
    diff = (got - want.float()).abs()
    assert (diff <= bound).all(), float((diff - bound).max())
    assert bound.max() < 0.1  # p flips over a few hundred rows, not more


# ---------------------------------------------- B3: the chunked scan


def test_scan_constants_are_the_kernels():
    src = (_build.CSRC_DIR / "scan_logsumexp.cu").read_text()
    assert re.search(rf"constexpr int kLaneRows = {psl.LANE_ROWS};", src)
    assert psl.CHUNK_ROWS == 32 * psl.LANE_ROWS


def emulate_scan(x, lane_rows=psl.LANE_ROWS):
    """csrc/scan_logsumexp.cu's scan of a (T, C) fp32 tensor, all columns
    at once: per chunk of 32 * lane_rows rows, lane i combines its
    lane_rows consecutive rows in order (rows past T leave its pair as it
    is), a Kogge-Stone over the 32 lanes' totals (__shfl_up_sync: lanes
    below the offset keep theirs), the exclusive prefix after the chunk
    carry, each pair combined with it, then the carry takes the chunk's
    total."""
    tt, c = x.shape
    chunk = 32 * lane_rows
    out = torch.empty_like(x)
    carry = (torch.full((c,), float("-inf")), torch.zeros(c))
    lane = torch.arange(32)[:, None]
    for t0 in range(0, tt, chunk):
        n = min(chunk, tt - t0)
        xs = torch.full((chunk, c), float("-inf"))
        xs[:n] = x[t0:t0 + n]
        xs = xs.view(32, lane_rows, c)
        valid = (torch.arange(chunk) < n).view(32, lane_rows)
        m = torch.full((32, c), float("-inf"))
        s = torch.zeros(32, c)
        pairs = []
        for k in range(lane_rows):
            m2, s2 = _combine(m, s, xs[:, k], torch.ones(32, c))
            keep = valid[:, k, None]
            m, s = torch.where(keep, m2, m), torch.where(keep, s2, s)
            pairs.append((m, s))
        off = 1
        while off < 32:
            up_m = torch.cat([m[:off], m[:-off]])
            up_s = torch.cat([s[:off], s[:-off]])
            m2, s2 = _combine(m, s, up_m, up_s)
            m, s = (torch.where(lane >= off, m2, m),
                    torch.where(lane >= off, s2, s))
            off *= 2
        em = torch.cat([torch.full((1, c), float("-inf")), m[:-1]])
        es = torch.cat([torch.zeros(1, c), s[:-1]])
        pre = _combine(carry[0][None], carry[1][None], em, es)
        res = torch.stack([
            (lambda om, os: torch.log(os.clamp_min(1e-37)) + om)(
                *_combine(pre[0], pre[1], pm, ps)) for pm, ps in pairs],
            dim=1)  # (32, lane_rows, C)
        out[t0:t0 + n] = res.reshape(chunk, c)[:n]
        carry = _combine(carry[0], carry[1], m[31], s[31])
    return out


@pytest.mark.parametrize("tt", [1, 33, 375, 384, 700])
def test_chunked_scan_matches_jax(tt):
    """The emulated scan against the TPU kernel (interpret) and the twin:
    columns drifting 8.5 nats a frame (as the CTC terms do), -inf prefixes
    and an all -inf column; within 1e-4 + 1e-6 |x| (the limit of the card
    tests), -inf exactly where JAX has it."""
    from avsr_tpu.ops.pallas.scan_logsumexp import cumlogsumexp

    rng = np.random.RandomState(tt)
    c = 37
    x = rng.randn(tt, c).astype(np.float32) * 3.0
    x -= 8.5 * np.arange(tt, dtype=np.float32)[::-1, None]
    x[: tt // 2, : c // 3] = -np.inf
    x[:, -1] = -np.inf
    got = emulate_scan(t(x)).numpy()
    for want in (np.asarray(cumlogsumexp(jnp.asarray(x))),
                 psl.cumlogsumexp_plain(t(x)).numpy()):
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        assert not np.isnan(got).any()
        fin = np.isfinite(want)
        assert (np.abs(got[fin] - want[fin])
                <= 1e-4 + 1e-6 * np.abs(want[fin])).all()
