"""The port's kernel twins vs the JAX Pallas kernels (interpret mode, CPU).

On a CPU tensor each wrapper runs its plain twin; the CUDA kernels
themselves are held against the same twins on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu_torch.ops.kernels import beam_update as pbu  # noqa: E402
from avsr_tpu_torch.ops.kernels import decode_attention as pda  # noqa: E402
from avsr_tpu_torch.ops.kernels import flash_attention as pfa  # noqa: E402
from avsr_tpu_torch.ops.kernels import row_gather as prg  # noqa: E402
from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl  # noqa: E402
from avsr_tpu_torch.ops.kernels import stem_fuse as psf  # noqa: E402
from avsr_tpu_torch.ops.kernels import topk as ptk  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    beam_step_case, c1_topk, decode_case, setup_torch, t, wide_topk)

NEG = -1.0e30


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


# ---------------------------------------------------------------- flash


@pytest.mark.parametrize("tt,d", [(100, 16), (128, 64), (200, 32)])
def test_flash_plain_matches_jax(tt, d):
    """Padding bias on a ragged tail; T not a multiple of 128 included."""
    from avsr_tpu.ops.pallas.flash_attention import flash_attention

    rng = np.random.RandomState(tt)
    n = 3
    q, k, v = (rng.randn(n, tt, d).astype(np.float32) for _ in range(3))
    lens = np.asarray([tt, tt - 17, tt // 2])
    bias = np.where(np.arange(tt)[None, :] < lens[:, None], 0.0, NEG)
    bias = bias.astype(np.float32)
    scale = d ** -0.5
    want = flash_attention(*(jnp.asarray(x) for x in (q, k, v, bias)),
                           scale=scale)
    got, lse = pfa.flash_attention_fwd(t(q), t(k), t(v), t(bias), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    # lse is the row normaliser of the same scores
    s = np.einsum("ntd,nsd->nts", q, k) * scale + bias[:, None, :]
    m = s.max(-1)
    ref_lse = m + np.log(np.exp(s - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_mha_flash_matches_jax(masked):
    from avsr_tpu.ops.pallas.flash_attention import mha_flash

    rng = np.random.RandomState(11)
    b, tt, h, dh = 2, 37, 2, 16
    q, k, v = (rng.randn(b, tt, h, dh).astype(np.float32) for _ in range(3))
    mask = (np.arange(tt)[None, :] < np.asarray([37, 20])[:, None]) if masked else None
    want = mha_flash(*(jnp.asarray(x) for x in (q, k, v)),
                     None if mask is None else jnp.asarray(mask), scale=0.25)
    got = pfa.mha_flash(t(q), t(k), t(v), None if mask is None else t(mask),
                        scale=0.25)
    assert got.shape == (b, tt, h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


# ---------------------------------------------------------------- decode


@pytest.mark.parametrize("pos", [0, 11, 63, 64, 90])
def test_decode_attention_plain_matches_jax(pos):
    """Resident v3 with the in-kernel row write; pos >= S clamps the
    write to the last row (S = 64); B = 3 utterances, K = 3 lanes."""
    from avsr_tpu.ops.pallas.decode_attention import decode_attention

    q, kv, row, bias = decode_case(pos, pos=pos)
    want, want_kv = decode_attention(
        jnp.asarray(pos), jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bias),
        lanes=3, heads=4, kv_row=jnp.asarray(row), resident=True)
    cache = t(kv)
    got, got_kv = pda.decode_attention(pos, t(q), cache, t(bias), 3, 4, t(row))
    assert got_kv is cache  # updated in place
    np.testing.assert_array_equal(got_kv.numpy(), np.asarray(want_kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_decode_attention_plain_bf16_cache_rounding():
    """q and probabilities round to the cache dtype as in the TPU kernel.
    At these inputs the twin equals the JAX kernel bit for bit (measured);
    1e-4 abs leaves fp32 summation-order room, while a twin that skipped
    the rounding of p would be ~4e-3 off."""
    from avsr_tpu.ops.pallas.decode_attention import decode_attention

    q, kv, row, bias = decode_case(7, b=1, pos=20)
    kv16 = jnp.asarray(kv).astype(jnp.bfloat16)
    want, want_kv = decode_attention(
        jnp.asarray(20), jnp.asarray(q), kv16, jnp.asarray(bias),
        lanes=3, heads=4, kv_row=jnp.asarray(row), resident=True)
    cache = t(kv).to(torch.bfloat16)
    got, got_kv = pda.decode_attention(20, t(q), cache, t(bias), 3, 4, t(row))
    np.testing.assert_array_equal(
        got_kv.float().numpy(), np.asarray(want_kv.astype(jnp.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# ---------------------------------------------------------------- topk


@pytest.mark.parametrize("rows,v,k", [(9, 61, 4), (24, 5049, 4), (8, 15, 3),
                                      (9, 61, 1), (9, 61, 8)])
def test_topk_plain_matches_jax_with_ties(rows, v, k):
    from avsr_tpu.ops.pallas.topk import topk_lastdim

    rng = np.random.RandomState(v)
    x = rng.randn(rows, v).astype(np.float32)
    # ties: repeat each row's max at later columns, and a block of equal
    # values; a row of -1e30 sentinels with one live entry
    x[:, v // 2] = x.max(axis=1)
    x[:, -1] = x.max(axis=1)
    x[1, :] = 0.5
    x[2, :] = NEG
    x[2, 5] = -2.0
    want_v, want_i = topk_lastdim(jnp.asarray(x), k)
    got_v, got_i = ptk.topk_lastdim(t(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _inf_rows(v, seed):
    """Rows with fewer finite entries than the rounds: none, one at the
    end, two, one at the start with -inf after it, and a row that also
    holds +inf; then random rows."""
    rng = np.random.RandomState(seed)
    x = rng.randn(7, v).astype(np.float32)
    x[0] = -np.inf
    x[1] = -np.inf
    x[1, v - 1] = 2.0
    x[2] = -np.inf
    x[2, [0, v // 2]] = [-3.0, 1.0]
    x[3, 1:] = -np.inf
    x[4, :] = -np.inf
    x[4, [v // 3, v - 2]] = [np.inf, 0.5]
    return x


@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("v", [15, 61])
def test_topk_plain_matches_jax_on_the_inf_rule(v, k):
    """Once a row's finite entries are used up, each round's max is -inf
    and its index the lowest index whose current value is -inf, which can
    be one chosen in an earlier round: the JAX kernel (interpret) and the
    twin agree on every such row."""
    from avsr_tpu.ops.pallas.topk import topk_lastdim

    x = _inf_rows(v, v + k)
    want_v, want_i = topk_lastdim(jnp.asarray(x), k)
    got_v, got_i = ptk.topk_lastdim(t(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # the rule shows: a row with one finite entry repeats an index
    assert len(set(got_i[1].tolist())) < k or k == 1


INT_MAX = 2**31 - 1


def _merge(lists, k):
    """csrc/topk.cu merge_warp over lists (each sorted, padded with (-inf,
    INT_MAX)): k rounds, each the largest head value, then the smallest
    index holding it, every list whose head holds that index popping it."""
    out = []
    lists = [list(lst) for lst in lists]
    for _ in range(k):
        best = min((lst[0] for lst in lists), key=lambda e: (-e[0], e[1]))
        out.append(best)
        for lst in lists:
            if lst[0][1] == best[1]:
                lst.pop(0)
                lst.append((-np.inf, INT_MAX))
    return out


def _topk_one_pass(row, k, offset, threads=256):
    """csrc/topk.cu on one row: each thread's best K entries of the
    elements it reads (the block kernel's head, 16-byte chunks and tail,
    ``offset`` the row's start in floats modulo 4, or a warp's strided
    scalars for short rows), merged a warp and then a block at a time,
    then ``finish``'s -inf rule."""
    v = len(row)
    kk = next(n for n in (4, 8, 16, 32) if n >= k)
    pad = [(-np.inf, INT_MAX)] * kk

    def best(idx):
        es = sorted(((float(row[i]), i) for i in idx if not np.isnan(row[i])),
                    key=lambda e: (-e[0], e[1]))
        return (es + pad)[:kk]

    if v <= ptk.WARP_ROW_MAX:
        merged = _merge([best(range(lane, v, 32)) for lane in range(32)], k)
    else:
        head = min(v, (4 - offset % 4) % 4)
        nvec = (v - head) // 4
        end = head + 4 * nvec
        warps = []
        for w in range(threads // 32):
            lanes = []
            for lane in range(32):
                t = 32 * w + lane
                idx = [e for q in range(t, nvec, threads)
                       for e in range(head + 4 * q, head + 4 * q + 4)]
                idx += [t] if t < head else []
                idx += [end + t] if t < v - end else []
                lanes.append(best(idx))
            warps.append(_merge(lanes, k) + pad)
        merged = _merge(warps, k)
    c = next((r for r in range(k) if not merged[r][0] > -np.inf), k)
    j = min([merged[c][1]] + [e[1] for e in merged[:c]]) if c < k else None
    vals = [e[0] if r < c else -np.inf for r, e in enumerate(merged)]
    ids = [e[1] if r < c else j for r, e in enumerate(merged)]
    return np.float32(vals), np.int64(ids)


@pytest.mark.parametrize("v,k,offset", [
    (15, 3, 0), (15, 8, 0), (61, 4, 0), (1024, 9, 0), (5049, 4, 0),
    (5049, 4, 1), (5049, 4, 3), (1025, 8, 2), (5049, 32, 1)])
def test_topk_one_pass_design_matches_the_twin(v, k, offset):
    """The kernel's design, emulated element by element (per-thread lists
    of the elements each thread reads, warp and block merges, the -inf
    rule from the merged list), gives the twin's values and indices on
    rows with ties, equal values, +inf and too few finite entries."""
    x = np.concatenate([_inf_rows(v, v + k), np.random.RandomState(k).randn(
        2, v).astype(np.float32)])
    x[5, v // 2] = x[5].max()
    x[6] = 0.25
    want_v, want_i = ptk.topk_plain(t(x), k)
    for r in range(len(x)):
        got_v, got_i = _topk_one_pass(x[r], k, (offset + r * v) % 4)
        np.testing.assert_array_equal(got_i, want_i[r].numpy())
        np.testing.assert_array_equal(got_v, want_v[r].numpy())


def test_topk_route_constant_is_the_sources():
    """The wrapper counts the warp-a-row launches by the source's limit."""
    from avsr_tpu_torch.ops.kernels import _build

    src = (_build.CSRC_DIR / "topk.cu").read_text()
    assert (f"constexpr int kWarpRowMax = {ptk.WARP_ROW_MAX};" in src
            and f"constexpr int kMaxK = {ptk.MAX_K};" in src)


def test_topk_leading_axes():
    x = np.random.RandomState(3).randn(2, 3, 40).astype(np.float32)
    vals, ids = ptk.topk_lastdim(t(x), 4)
    assert vals.shape == ids.shape == (2, 3, 4)
    np.testing.assert_array_equal(ids.numpy(), np.argsort(-x, axis=-1)[..., :4])


# ---------------------------------------------------------------- beam_update


def _order_key(v):
    """csrc/common.cuh order_key: a uint32 in the order of the floats, -0
    as +0."""
    b = int(np.array([v + np.float32(0)], np.float32).view(np.uint32)[0])
    return b ^ (0xFFFFFFFF if b >> 31 else 0x80000000)


def _beam_update_design(i, args, *, w_dec, w_ctc, eos, neg, d_end, m_end,
                        threads=128, items=1):
    """csrc/beam_update.cu on numpy arrays, element by element: warp 0's
    candidates f = lane + 32t with the weighting's fp32 roundings in the
    unfused step's order (eos among a hypothesis' pre-beam ids from a
    ballot of the candidates' ids), k rounds of (__reduce_max_sync of the
    lanes' best order keys, __reduce_min_sync of the flat index among the
    lanes holding it, that candidate to -inf), lane r keeping round r, the
    lane-parallel bookkeeping (ballots, a warp max), then the (B, G) grid's
    threads each writing its items (columns of the token buffers, the best
    row and the ended statistics; ancestry rows) from the K source rows it
    loaded. Asserts that every element of the copied outputs is written once."""
    (xlens, dec_top, dec_eos, psi_cand, psi_eos, ctc_s, part_ids, score,
     alive, stop, yseq, anc, ended_best, ended_cnt, best_score, best_yseq,
     best_len) = args
    f32 = np.float32
    b_n, k, sp = part_ids.shape
    c, ll, s_rows = sp + 1, yseq.shape[2], anc.shape[0]
    nc = k * c
    assert k <= 16 and nc <= 128
    small = {name: np.zeros((b_n, k), dt) for name, dt in (
        ("token", np.int64), ("prev", np.int64), ("slot", np.int64),
        ("psi_sel", np.float32), ("score", np.float32), ("alive", bool))}
    out = dict(small, best_score=np.zeros(b_n, np.float32),
               best_len=np.zeros(b_n, np.int64), stop=np.zeros(b_n, bool),
               yseq=np.zeros_like(yseq), anc=np.zeros_like(anc),
               ended_best=np.zeros_like(ended_best),
               ended_cnt=np.zeros_like(ended_cnt),
               best_yseq=np.zeros_like(best_yseq))
    writes = {name: np.zeros(out[name].shape, int) for name in (
        "yseq", "anc", "ended_best", "ended_cnt", "best_yseq")}
    g = -(-(ll + s_rows) // (threads * items))
    key_inf = _order_key(f32(-np.inf))
    for b in range(b_n):
        lane_active = not stop[b] and i < xlens[b]
        forced = i >= xlens[b] - 1
        # warp 0: weights, tokens, psi of the candidates; keys in lanes
        w = np.zeros(nc, np.float32)
        tok = np.zeros(nc, np.int64)
        psi = np.zeros(nc, np.float32)
        keys = [[0] * 4 for _ in range(32)]
        # bit f of the ballots: candidate f's pre-beam id is eos
        eos_at = sum(1 << f for f in range(nc) if f % c != sp
                     and part_ids[b, f // c, f % c] == eos)
        for f in range(nc):
            j, q = divmod(f, c)
            eos_slot = q == sp
            dec = dec_eos[b, j] if eos_slot else dec_top[b, j, q]
            wv = f32(w_dec) * dec
            if psi_cand is not None:
                psi[f] = psi_eos[b, j] if eos_slot else psi_cand[b, j, q]
                wv = wv + f32(w_ctc) * (psi[f] - ctc_s[b, j])
            if eos_slot and eos_at >> (j * c) & ((1 << sp) - 1):
                wv = f32(neg)
            wv = wv + score[b, j]
            if not alive[b, j]:
                wv = f32(neg)
            w[f], tok[f] = wv, (eos if eos_slot else part_ids[b, j, q])
            keys[f % 32][f // 32] = _order_key(wv)
        sel_r, inf_r = [0] * 32, [False] * 32
        for r in range(k):
            best = []
            for lane in range(32):  # the lane's largest key, lowest t
                tb = max(range(4), key=lambda t: (keys[lane][t], -t))
                best.append((keys[lane][tb], lane + 32 * tb))
            mk = max(kb for kb, _ in best)
            sel = min(f for kb, f in best if kb == mk)
            keys[sel % 32][sel // 32] = key_inf
            sel_r[r], inf_r[r] = sel, mk == key_inf
        # lane r < k: round r's candidate
        top = [f32(-np.inf) if inf_r[r] else w[sel_r[r]] for r in range(k)]
        toks = [tok[sel_r[r]] for r in range(k)]
        prev = [sel_r[r] // c for r in range(k)]
        ended = [(toks[r] == eos or forced) and lane_active for r in range(k)]
        es = [top[r] if ended[r] else f32(neg) for r in range(k)]
        step_best = max(es)
        best_slot = min(r for r in range(k) if es[r] == step_best)
        n_ended = sum(ended)
        better = step_best > best_score[b] and lane_active
        bsc = step_best if better else best_score[b]
        alive_o = [(not ended[r] and lane_active) if lane_active
                   else alive[b, r] for r in range(k)]
        count = 0
        for mm in range(m_end):
            j = i - mm - 2
            jc = max(j, 0)
            cnt, eb = ended_cnt[b, jc], ended_best[b, jc]
            if jc == i:
                cnt, eb = cnt + n_ended, max(eb, step_best)
            count += j >= 0 and cnt > 0 and f32(eb - bsc) < d_end
        for r in range(k):
            out["token"][b, r], out["prev"][b, r] = toks[r], prev[r]
            out["slot"][b, r] = sel_r[r] - prev[r] * c
            out["psi_sel"][b, r] = psi[sel_r[r]]
            out["score"][b, r] = ((top[r] if alive_o[r] else f32(neg))
                                  if lane_active else score[b, r])
            out["alive"][b, r] = alive_o[r]
        out["best_score"][b] = bsc
        out["best_len"][b] = (i + (3 if forced else 2) if better
                              else best_len[b])
        out["stop"][b] = stop[b] or ((count >= m_end or not any(alive_o))
                                     and lane_active)

        # every thread of the (B, G) grid: its items from its loads
        def successor(src, j, col):
            v = src[prev[j]]
            if col == i + 1:
                v = toks[j]
            if col == i + 2 and forced:
                v = eos
            return v

        for gy in range(g):
            for tid in range(threads):
                for u in range(items):
                    e = (u * g + gy) * threads + tid
                    if e < ll:
                        src = yseq[b, :, e]
                        for j in range(k):
                            out["yseq"][b, j, e] = (
                                successor(src, j, e) if lane_active
                                else src[j])
                            writes["yseq"][b, j, e] += 1
                        out["best_yseq"][b, e] = (
                            successor(src, best_slot, e) if better
                            else best_yseq[b, e])
                        out["ended_best"][b, e] = (
                            max(ended_best[b, e], step_best) if e == i
                            else ended_best[b, e])
                        out["ended_cnt"][b, e] = ended_cnt[b, e] + (
                            n_ended if e == i else 0)
                        for name in ("best_yseq", "ended_best", "ended_cnt"):
                            writes[name][b, e] += 1
                    elif e < ll + s_rows:
                        src = anc[e - ll, b]
                        for j in range(k):
                            out["anc"][e - ll, b, j] = src[prev[j]]
                            writes["anc"][e - ll, b, j] += 1
    for name, n in writes.items():
        assert (n == 1).all(), name
    return out


def _inf_lanes(case, lanes):
    """Lanes whose candidates are all -inf but one: at lanes[0] the finite
    one is flat index 0, so the later rounds (maximum -inf) take index 0
    again; at lanes[1] it is the eos slot of hypothesis 1, so they take
    index 0, not chosen before."""
    for b, keep in zip(lanes, ((0, 0), (1, None))):
        case["dec_top"][b] = -np.inf
        case["dec_eos"][b] = -np.inf
        j, q = keep
        if q is None:
            case["dec_eos"][b, j] = -1.0
        else:
            case["dec_top"][b, j, q] = -1.0
    return case


@pytest.mark.parametrize("use_ctc,dyadic", [(True, False), (False, False),
                                            (True, True)])
@pytest.mark.parametrize("seed,i,k,sp,items", [(0, 4, 3, 4, 1),
                                               (1, 9, 3, 4, 2),
                                               (2, 17, 16, 7, 1)])
def test_beam_update_warp_design_matches_the_twin(seed, i, k, sp, items,
                                                  use_ctc, dyadic):
    """The kernel's design, emulated element by element (the warp top-k on
    order keys with lowest-index ties, rounds whose maximum is -inf, dead
    hypotheses at neg, eos among the pre-beam ids, the lane-parallel
    bookkeeping and the grid's copies from registers), gives every output
    of the twin, at the shipped shape (K=3, 15 candidates) and the
    kernel's limits (K=16, 128 candidates), one or two items a thread."""
    case = beam_step_case(seed, i, use_ctc=use_ctc, dyadic=dyadic, b=8, k=k,
                          sp=sp, ll=40, s_rows=24)
    case = _inf_lanes(case, (6, 7))
    kw = dict(BU_KW, w_ctc=0.1 if use_ctc else 0.0,
              w_dec=0.9 if use_ctc else 1.0)
    want = pbu.beam_update_plain(i, *(None if x is None else t(x)
                                      for x in case.values()), **kw)
    got = _beam_update_design(i, list(case.values()), **kw, threads=16,
                              items=items)
    assert want["token"][6].tolist() == [case["part_ids"][6, 0, 0]] * k
    assert want["prev"][7].tolist() == [1] + [0] * (k - 1)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w.numpy(), err_msg=name)


def _beam_update_wide_design(i, args, *, w_dec, w_ctc, eos, neg, d_end,
                             m_end, per=4, items=32):
    """csrc/beam_update.cu beam_update_wide_kernel on numpy arrays: the
    weights in the unfused step's fp32 order (eos among a hypothesis' pre-beam
    ids from flags set by the candidates' ids), the top-k of ``wide_topk``
    (each chunk's bitonic sort, the lists' places, the -inf rule), warp 0's
    bookkeeping over K, and every block of the (B, G) grid copying its
    ``items`` columns or ancestry rows, all K source values of each, into a
    tile and writing its outputs from the tile; block 0 of an utterance
    writes the per-hypothesis and per-utterance outputs. Asserts that every
    output element is written once. Returns (outputs, the chunks each
    utterance's listed rounds came from)."""
    (xlens, dec_top, dec_eos, psi_cand, psi_eos, ctc_s, part_ids, score,
     alive, stop, yseq, anc, ended_best, ended_cnt, best_score, best_yseq,
     best_len) = args
    f32 = np.float32
    b_n, k, sp = part_ids.shape
    c, ll, s_rows = sp + 1, yseq.shape[2], anc.shape[0]
    nc = k * c
    out = dict(token=np.zeros((b_n, k), np.int64),
               prev=np.zeros((b_n, k), np.int64),
               slot=np.zeros((b_n, k), np.int64),
               psi_sel=np.zeros((b_n, k), np.float32),
               score=np.zeros((b_n, k), np.float32),
               alive=np.zeros((b_n, k), bool),
               yseq=np.zeros_like(yseq), anc=np.zeros_like(anc),
               ended_best=np.zeros_like(ended_best),
               ended_cnt=np.zeros_like(ended_cnt),
               best_score=np.zeros(b_n, np.float32),
               best_len=np.zeros(b_n, np.int64), stop=np.zeros(b_n, bool),
               best_yseq=np.zeros_like(best_yseq))
    writes = {name: np.zeros(x.shape, int) for name, x in out.items()}
    g = -(-(ll + s_rows) // items)
    chunks = []
    for b in range(b_n):
        lane_active = not stop[b] and i < xlens[b]
        forced = i >= xlens[b] - 1
        dup = [(part_ids[b, j] == eos).any() for j in range(k)]
        w = np.zeros(nc, np.float32)
        tok = np.zeros(nc, np.int64)
        psi = np.zeros(nc, np.float32)
        for f in range(nc):
            j, q = divmod(f, c)
            eos_slot = q == sp
            dec = dec_eos[b, j] if eos_slot else dec_top[b, j, q]
            wv = f32(w_dec) * dec
            if psi_cand is not None:
                psi[f] = psi_eos[b, j] if eos_slot else psi_cand[b, j, q]
                wv = wv + f32(w_ctc) * (psi[f] - ctc_s[b, j])
            if eos_slot and dup[j]:
                wv = f32(neg)
            wv = wv + score[b, j]
            if not alive[b, j]:
                wv = f32(neg)
            w[f], tok[f] = wv, (eos if eos_slot else part_ids[b, j, q])
        rounds, came = wide_topk(w, k, per)
        chunks.append(came)
        # warp 0: hypothesis r in lane r
        toks = [tok[f] for f, _ in rounds]
        prev = [f // c for f, _ in rounds]
        ended = [(toks[r] == eos or forced) and lane_active for r in range(k)]
        es = [top if ended[r] else f32(neg)
              for r, (_, top) in enumerate(rounds)]
        step_best = max(es)
        best_slot = es.index(step_best)
        n_ended = sum(ended)
        better = step_best > best_score[b] and lane_active
        bsc = step_best if better else best_score[b]
        alive_o = [(not ended[r] and lane_active) if lane_active
                   else alive[b, r] for r in range(k)]
        count = 0
        for mm in range(m_end):
            j = i - mm - 2
            jc = max(j, 0)
            cnt, eb = ended_cnt[b, jc], ended_best[b, jc]
            if jc == i:
                cnt, eb = cnt + n_ended, max(eb, step_best)
            count += j >= 0 and cnt > 0 and f32(eb - bsc) < d_end
        for gy in range(g):
            e0 = gy * items
            e1 = min(e0 + items, ll + s_rows)
            cols = max(0, min(e1, ll) - e0)
            a0, arows = max(e0, ll) - ll, max(0, e1 - max(e0, ll))
            tile = np.zeros((k, items), np.int64)
            tile[:, :cols] = yseq[b, :, e0:e0 + cols]
            tile[:, cols:cols + arows] = anc[a0:a0 + arows, b].T
            if gy == 0:
                for r, (f, top) in enumerate(rounds):
                    vals = dict(token=toks[r], prev=prev[r],
                                slot=f - prev[r] * c, psi_sel=psi[f],
                                score=((top if alive_o[r] else f32(neg))
                                       if lane_active else score[b, r]),
                                alive=alive_o[r])
                    for name, v in vals.items():
                        out[name][b, r] = v
                        writes[name][b, r] += 1
                vals = dict(best_score=bsc,
                            best_len=(i + (3 if forced else 2) if better
                                      else best_len[b]),
                            stop=stop[b] or ((count >= m_end
                                              or not any(alive_o))
                                             and lane_active))
                for name, v in vals.items():
                    out[name][b] = v
                    writes[name][b] += 1

            def successor(j, u, e):
                v = tile[prev[j], u]
                if e == i + 1:
                    v = toks[j]
                if e == i + 2 and forced:
                    v = eos
                return v

            for j in range(k):
                for u in range(cols):
                    e = e0 + u
                    out["yseq"][b, j, e] = (successor(j, u, e)
                                            if lane_active else tile[j, u])
                    writes["yseq"][b, j, e] += 1
            for u in range(cols):
                e = e0 + u
                out["best_yseq"][b, e] = (successor(best_slot, u, e)
                                          if better else best_yseq[b, e])
                out["ended_best"][b, e] = (max(ended_best[b, e], step_best)
                                           if e == i else ended_best[b, e])
                out["ended_cnt"][b, e] = ended_cnt[b, e] + (
                    n_ended if e == i else 0)
                for name in ("best_yseq", "ended_best", "ended_cnt"):
                    writes[name][b, e] += 1
            for u in range(arows):
                for j in range(k):
                    out["anc"][a0 + u, b, j] = tile[prev[j], cols + u]
                    writes["anc"][a0 + u, b, j] += 1
    for name, n in writes.items():
        assert (n == 1).all(), name
    return out, chunks


@pytest.mark.parametrize("use_ctc", [True, False])
@pytest.mark.parametrize("k,sp,per,items", [(17, 7, 4, 32), (10, 15, 4, 32),
                                            (22, 33, 4, 32), (3, 43, 4, 32),
                                            (10, 15, 1, 7)])
def test_beam_update_wide_design_matches_the_twin(k, sp, per, items,
                                                  use_ctc):
    """The wide kernel's design, emulated element by element (each chunk's
    bitonic sort into a list, the lists' places, the -inf rule, dead
    hypotheses at neg, eos among the pre-beam ids, warp 0's bookkeeping,
    the grid's tiles and copies), gives every output of the twin bit for
    bit, at 17 hypotheses, beams 10 and 22 and 132 candidates of 3; with
    lanes whose candidates are all -inf but one, and the K best of a lane
    drawn from more than one chunk's list; also with chunks of 32 and 7
    items a block (tiles across the token buffer's end)."""
    case = beam_step_case(k + sp, 9, use_ctc=use_ctc, b=8, k=k, sp=sp,
                          ll=40, s_rows=24, eos=60)
    case = _inf_lanes(case, (6, 7))
    # lane 0: the last hypothesis' eos slot (in the last chunk) wins
    case["dec_eos"][0, k - 1] = 20.0
    kw = dict(BU_KW, eos=60, w_ctc=0.1 if use_ctc else 0.0,
              w_dec=0.9 if use_ctc else 1.0)
    want = pbu.beam_update_plain(9, *(None if x is None else t(x)
                                      for x in case.values()), **kw)
    got, chunks = _beam_update_wide_design(9, list(case.values()), **kw,
                                           per=per, items=items)
    assert want["token"][6].tolist() == [case["part_ids"][6, 0, 0]] * k
    assert want["prev"][7].tolist() == [1] + [0] * (k - 1)
    assert want["prev"][0, 0] == k - 1 and len(set(chunks[0])) > 1
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w.numpy(), err_msg=name)


@pytest.mark.parametrize("per", [1, 4])
def test_beam_update_wide_design_skips_nan(per):
    """The wide kernel's top-k never chooses NaN and keeps C1's -inf rule
    (``c1_topk``) on weights with NaN, -inf, ties across chunks and too
    few entries above -inf: 748 candidates, K = 22; where every candidate
    is NaN the rule has no index and takes candidate 0."""
    rng = np.random.RandomState(per)
    rows = rng.randint(-3, 3, size=(6, 748)).astype(np.float32)
    rows[0, ::3] = np.nan
    rows[1] = np.nan
    rows[1, [5, 300, 700]] = [1.0, -np.inf, -2.0]
    rows[2, :500] = np.nan
    rows[2, 500:] = -np.inf
    rows[2, 600] = 3.0
    rows[3, 1::2] = -np.inf
    rows[4] = np.nan
    want_v, want_i = c1_topk(rows, 22)
    want_i[4] = 0
    for r, row in enumerate(rows):
        rounds, _ = wide_topk(row, 22, per)
        np.testing.assert_array_equal([f for f, _ in rounds], want_i[r])
        np.testing.assert_array_equal(np.float32([v for _, v in rounds]),
                                      want_v[r])


# ---------------------------------------------------------------- stem apply


def _apply_strips(x, g, b, al, rows, blocks):
    """csrc/stem_fuse.cu apply_kernel's walk over channels-last frames x
    (N, H, W, C) fp32, element by element: strips of `rows` output rows
    of a frame, each block of `blocks` a run of consecutive strips; a
    strip's stage holds only the input rows it fetched (its first row
    2o0 - 1 left out where the block's strip before, of the same frame,
    carries that row's maxima); y = PReLU(x g + b) in the kernel's fp32
    roundings, the max over each window column's three input columns of a
    row, each window's max down the column. Asserts that every output
    window is written once and that a carried row equals that row's
    maxima from x. Returns the fp32 pooled (N, H/2, W/2, C)."""
    n, h, w, c = x.shape
    ho, wo = h // 2, w // 2
    per_frame = -(-ho // rows)
    strips = n * per_frame
    out = np.full((n, ho, wo, c), np.nan, np.float32)
    written = np.zeros((n, ho, wo), int)

    def row_max(row):  # (W, C) input row -> (wo, C) window-column maxima
        z = row * g + b
        y = np.where(z >= 0, z, al * z).astype(np.float32)
        yp = np.concatenate([np.full((1, c), -np.inf, np.float32), y])
        return np.maximum(np.maximum(yp[0:w:2], yp[1:w + 1:2]),
                          yp[2:w + 2:2])

    for blk in range(blocks):
        first, last = strips * blk // blocks, strips * (blk + 1) // blocks
        carry = None
        for s in range(first, last):
            f, o0 = s // per_frame, s % per_frame * rows
            o1 = min(o0 + rows, ho)
            carried = s > first and o0 > 0
            r0 = 2 * o0 if carried else max(2 * o0 - 1, 0)
            stage = {r: x[f, r] for r in range(r0, 2 * o1)}
            if carried:
                np.testing.assert_array_equal(carry, row_max(x[f, 2 * o0 - 1]))
                top = carry
            elif o0 > 0:
                top = row_max(stage[2 * o0 - 1])
            else:
                top = np.full((wo, c), -np.inf, np.float32)
            for oh in range(o0, o1):
                mid, bot = row_max(stage[2 * oh]), row_max(stage[2 * oh + 1])
                out[f, oh] = np.maximum(np.maximum(top, mid), bot)
                written[f, oh] += 1
                top = bot
            carry = top
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("hw", [8, 44])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6])
def test_apply_strip_walk_matches_the_twin(rows, hw):
    """The apply kernel's strip walk, emulated (strip ends, frame ends, the
    halo row, the carried row, runs of strips that cross frames), gives
    the twin's pooled output bit for bit given the same statistics, in
    fp32 and rounded once to bf16."""
    rng = np.random.RandomState(rows * 100 + hw)
    n, c = 5, 3
    x = (rng.randn(n, c, hw, hw) * 2.0 + 0.3).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    alpha = (0.25 + 0.05 * rng.randn(c)).astype(np.float32)
    mean = (0.1 * rng.randn(c)).astype(np.float32)
    var = (1.0 + rng.rand(c)).astype(np.float32)
    rstd = torch.rsqrt(t(var) + 1e-5)
    g, b = (v.numpy() for v in psf._affine(t(mean), rstd, t(scale),
                                            t(bias)))
    xl = x.transpose(0, 2, 3, 1).copy()
    for dtype in (torch.float32, torch.bfloat16):
        xd = t(x).to(dtype)
        want = psf.bn_prelu_pool_plain(xd, t(scale), t(bias), t(alpha),
                                       train=False, running_mean=t(mean),
                                       running_var=t(var))
        xs = xd.float().numpy().transpose(0, 2, 3, 1).copy() if (
            dtype == torch.bfloat16) else xl
        for blocks in (1, 2, 7, 64):
            got = _apply_strips(xs, g, b, alpha, rows, blocks)
            got = torch.from_numpy(got.transpose(0, 3, 1, 2).copy()).to(dtype)
            assert torch.equal(got, want), (dtype, blocks)


# ---------------------------------------------------------------- wrappers


def _step_args(i=5, **kw):
    return [None if x is None else t(x)
            for x in beam_step_case(0, i, **kw).values()]


BU_KW = dict(w_dec=0.9, w_ctc=0.1, eos=49, neg=-1.0e30, d_end=-10.0, m_end=3)
COUNTERS = (pfa.flash_attention_fwd, pda.decode_attention, ptk.topk_lastdim,
            psl.cumlogsumexp, prg.row_gather, pbu.beam_update)


def test_cpu_dispatch_launches_no_kernel():
    before = [fn.launches for fn in COUNTERS]
    x = torch.randn(2, 8, 16)
    pfa.flash_attention(x, x, x, torch.zeros(2, 8))
    q, kv, row, bias = decode_case(1, b=1)
    pda.decode_attention(3, t(q), t(kv), t(bias), 3, 4, t(row))
    ptk.topk_lastdim(torch.randn(4, 10), 2)
    psl.cumlogsumexp(torch.randn(6, 4))
    prg.row_gather(torch.randn(6, 4), torch.tensor([5, 0]))
    pbu.beam_update(5, *_step_args(), **BU_KW)
    assert [fn.launches for fn in COUNTERS] == before


def _cpu_route(route):
    """(module, its twin's name, a call of the wrapper on the CPU)."""
    from avsr_tpu_torch.ops.kernels import decoder_layer as pdl

    x = torch.randn(2, 8, 16)
    bias = torch.zeros(2, 8)
    if route == "flash":
        return pfa, "flash_attention_plain", lambda: pfa.flash_attention_fwd(
            x, x, x, bias)
    if route in ("flash_dq", "flash_dkv"):
        out, lse = pfa.flash_attention_plain(x, x, x, bias)
        if route == "flash_dq":
            return pfa, "attention_delta_plain", lambda: (
                pfa.flash_attention_bwd_dq(x, x, x, bias, out, x, lse))
        delta = pfa.attention_delta_plain(out, x)
        return pfa, "_bwd_from_delta", lambda: pfa.flash_attention_bwd_dkv(
            x, x, x, bias, x, lse, delta)
    if route == "decode":
        q, kv, row, lb = decode_case(1, b=1)
        return pda, "decode_attention_plain", lambda: pda.decode_attention(
            3, t(q), t(kv), t(lb), 3, 4, t(row))
    if route == "scan":
        return psl, "cumlogsumexp_plain", lambda: psl.cumlogsumexp(
            torch.randn(6, 4))
    from avsr_tpu_torch.models.decoder import DecoderLayer

    packed = pdl.pack_layer_params(DecoderLayer(32, 4, 64), torch.float32)
    args = (torch.randn(2, 32), torch.randn(2, 4, 64), torch.randn(1, 3, 32),
            torch.randn(1, 3, 32), torch.zeros(1, 3), torch.zeros(1, 2, 4, 2))
    return pdl, "decoder_layer_step_plain", lambda: pdl.decoder_layer_step(
        2, *args, packed, 2, 4)


@pytest.mark.parametrize("route", ["flash", "flash_dq", "flash_dkv",
                                   "decode", "scan", "layer"])
def test_cpu_route_warms_exp_first(route, monkeypatch):
    """Each wrapper whose plain twin takes exps runs ``ops.cpu.warm_exp``
    before the twin on the CPU, once a process (ROADMAP C21: a fresh
    process's first threaded exp can come out ~2^-15 off under CPU
    contention)."""
    from avsr_tpu_torch.ops import cpu

    mod, name, call = _cpu_route(route)
    twin = getattr(mod, name)
    seen = []

    def spy(*args, **kwargs):
        seen.append(cpu.warm_exp.cache_info().currsize)
        return twin(*args, **kwargs)

    monkeypatch.setattr(mod, name, spy)
    cpu.warm_exp.cache_clear()
    call()
    call()
    assert seen[:2] == [1, 1]
    assert cpu.warm_exp.cache_info().misses == 1


@pytest.mark.parametrize("entry", ["encoder", "model"])
def test_cpu_modules_warm_exp_first(entry):
    """A caller that reaches an exp through the model's modules themselves,
    not through a wrapper or an entry point, warms torch's CPU exp before
    the first module runs, once a process (ROADMAP C21):
    ``AVHubertModel.forward`` and ``AVSRModel.forward`` on the CPU."""
    from avsr_tpu_torch.models.e2e import AVSRModel
    from avsr_tpu_torch.ops import cpu
    from tests.torch_port_common import tiny_port_cfg

    model = AVSRModel(tiny_port_cfg()).eval()
    seen = []
    model.encoder.feature_extractor_audio.proj.register_forward_pre_hook(
        lambda *_: seen.append(cpu.warm_exp.cache_info().currsize))
    rng = np.random.RandomState(0)
    video = t(rng.randn(1, 4, 88, 88, 1).astype(np.float32))
    audio = t(rng.randn(1, 4, 104).astype(np.float32))
    lengths = torch.tensor([4])
    if entry == "encoder":
        def call():
            return model.encoder(audio, video)
    else:
        def call():
            return model(video, audio, torch.tensor([[3, 4]]), lengths,
                         torch.tensor([2]))
    cpu.warm_exp.cache_clear()
    with torch.no_grad():
        call()
        call()
    assert seen == [1, 1]
    assert cpu.warm_exp.cache_info().misses == 1


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "k",
                                  "scan_dtype", "gather_index_dtype",
                                  "gather_rank", "update_shape",
                                  "update_ctc_operands", "topk_rows_table",
                                  "topk_rows_dtype", "topk_rows_rank"])
def test_wrappers_reject_bad_inputs(case):
    x = torch.randn(2, 8, 16)
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            ptk.topk_lastdim(torch.randn(4, 10, dtype=torch.float64), 2)
        elif case == "shape":
            pfa.flash_attention(x, x, x, torch.zeros(2, 9))
        elif case == "contiguity":
            q, kv, row, b = decode_case(2, b=1)
            pda.decode_attention(3, t(q).t().contiguous().t(), t(kv), t(b),
                                 3, 4, t(row))
        elif case == "k":
            ptk.topk_lastdim(torch.randn(4, 10), 11)
        elif case == "scan_dtype":
            psl.cumlogsumexp(torch.randn(6, 4, dtype=torch.float64))
        elif case == "gather_index_dtype":
            prg.row_gather(torch.randn(6, 4), torch.tensor([1], dtype=torch.int32))
        elif case == "gather_rank":
            prg.row_gather(torch.randn(6, 4, 2), torch.tensor([1]))
        elif case == "topk_rows_table":  # B*V rows asked, one short
            ptk.topk_gather_rows(torch.randn(2, 3, 10), 4,
                                 torch.randn(19, 8))
        elif case == "topk_rows_dtype":
            ptk.topk_gather_rows(torch.randn(2, 3, 10), 4,
                                 torch.randn(20, 8, dtype=torch.float64))
        elif case == "topk_rows_rank":
            ptk.topk_gather_rows(torch.randn(6, 10), 4, torch.randn(60, 8))
        elif case == "update_shape":
            args = _step_args()
            args[10] = args[10][:, :, :-1]  # yseq one column short
            pbu.beam_update(5, *args, **BU_KW)
        else:
            args = _step_args()
            args[4] = None  # psi_eos without psi_cand's partners
            pbu.beam_update(5, *args, **BU_KW)
