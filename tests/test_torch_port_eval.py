"""The evaluation entry point of the port against the JAX package's.

- C28 (ROADMAP): beams whose pre-beam k = int(1.5 beam) exceeds 32 (beam
  22), whose (K, S'+1) candidates exceed the warp kernel's 128 (beam 10)
  or whose lanes exceed decode_attention's one query tile of 8 decode
  token for token as the JAX ``beam_search_batched`` does, unfused and
  fused; the twins at those shapes against the JAX kernels in interpret
  mode; the kernels' designs beyond those limits emulated against the
  twins: the top-k's radix select (exact, NaN never chosen),
  beam_update's k rounds of a block-wide arg-max after the previous
  winner and the -inf rule, and decode_attention's query tiles and groups
  over the rank-split, chunked prefix.
- The Recognizer's async API against its sync call and the JAX one.
- ``avsr_tpu_torch.cli.evaluation.InferenceEngine(device="cpu")`` against
  ``avsr_tpu.cli.evaluation.InferenceEngine`` on one reference-format
  checkpoint (the tiny JAX model through ``flax_to_torch``), a toy
  tokenizer and mp4 + wav fixtures: ``eval_lrs2``, ``infer_video``,
  ``eval_avcocktail`` and ``mcorec_session_infer``, in fp32 (decoder
  weights and K|V cache fp32 on both sides, ROADMAP C13) and one bf16 case
  on a pinned input; the parser; and a subprocess that runs the engine
  without loading JAX.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu.data import tokenizer as jtok  # noqa: E402
from avsr_tpu_torch.data import tokenizer as ptok  # noqa: E402
from avsr_tpu_torch.ops.kernels import beam_update as pbu  # noqa: E402
from avsr_tpu_torch.ops.kernels import topk as ptk  # noqa: E402
from tests.test_torch_port_host import (  # noqa: E402
    write_fixture,
    write_toy_tokenizer,
)
from tests.torch_port_common import (  # noqa: E402
    beam_step_case,
    gather_spy,
    jax_tiny_model,
    pin_fbank_route,
    port_cfg,
    port_model,
    setup_torch,
    t,
    tiny_cfg,
    wide_topk,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT_MAX = 2**31 - 1
FP32 = {"decoder_cache_dtype": "float32", "decoder_param_dtype": "float32"}


@pytest.fixture(scope="module")
def base():
    setup_torch()
    cfg = tiny_cfg()
    return (cfg, *jax_tiny_model(cfg, seed=1))


def _batch(seed):
    rng = np.random.RandomState(seed)
    lens = (20, 13, 17)
    audio = [rng.randn(n, 104).astype(np.float32) for n in lens]
    video = [rng.randint(0, 256, size=(n, 88, 88, 1)).astype(np.uint8)
             for n in lens]
    return audio, video


def _recognizers(base, eos_boost=0.0, **kw):
    """(JAX, port) recognizers on the same weights; ``eos_boost`` raises
    eos's output bias so that hypotheses also end on their own eos."""
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu_torch.decode.recognizer import Recognizer

    cfg, jmodel, variables = base
    if eos_boost:
        params = jax.tree.map(lambda x: x, variables["params"])
        head = params["decoder"]["output_layer"]
        head["bias"] = head["bias"].at[cfg.eos].add(eos_boost)
        variables = {"params": params,
                     "batch_stats": variables["batch_stats"]}
    kw = dict(dict(t_buckets=(24,), max_decode_tokens=16,
                   video_wire="delta2"), **kw)
    return (JaxRecognizer(model=jmodel, variables=variables, cfg=cfg, **kw),
            Recognizer(model=port_model(cfg, variables), cfg=port_cfg(cfg),
                       device="cpu", **kw))


# ---------------------------------------------------------------- C28


def _inf_rows(v, seed):
    """Rows with ties, equal values, +inf and fewer finite entries than
    the rounds (the -inf rule), then random rows."""
    rng = np.random.RandomState(seed)
    x = rng.randn(9, v).astype(np.float32)
    x[0] = -np.inf
    x[1] = -np.inf
    x[1, [0, v // 2, v - 1]] = [-3.0, 1.0, 2.0]
    x[2, 10:] = -np.inf
    x[3, [v // 3, v - 2]] = np.inf
    x[4] = 0.25
    x[5, v // 2] = x[5].max()
    x[5, -1] = x[5].max()
    return x


def _keys(row):
    """csrc/topk.cu topk_wide_kernel's keys: order_key, NaN and -inf 0."""
    b = (row.astype(np.float32) + np.float32(0)).view(np.uint32)
    keys = b ^ np.where(b >> 31, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))
    return np.where(np.isnan(row) | (row == -np.inf), np.uint32(0),
                    keys).astype(np.uint32)


def _radix_select(row, k):
    """csrc/topk.cu's k > 32 kernel step by step: where more than k keys
    lie above 0, 8-bit digit passes from the top (a histogram of the keys
    sharing the prefix, the digit whose keys reach the k-th, an early stop
    where all of its keys are taken); the keys above the prefix and the
    lowest-index ones equal to it, in index order; sorted by (key
    descending, index ascending); the -inf rule for the slots left.
    Returns (values, indices)."""
    keys = _keys(row)
    prefix, mask, need = 0, 0xFFFFFFFF, 0
    if int((keys > 0).sum()) > k:
        prefix, mask, need = 0, 0, k
        for shift in (24, 16, 8, 0):
            inb = (keys & np.uint32(mask)) == prefix
            hist = np.bincount((keys[inb] >> shift) & 255, minlength=256)
            higher = 0
            for d in range(255, -1, -1):
                if higher < need <= higher + hist[d]:
                    break
                higher += hist[d]
            need -= higher
            prefix |= d << shift
            mask |= 255 << shift
            if hist[d] == need:
                break
    km = keys & np.uint32(mask)
    chosen = np.concatenate([np.flatnonzero(km > prefix),
                             np.flatnonzero(km == prefix)[:need]])
    order = chosen[np.lexsort((chosen, -keys[chosen].astype(np.int64)))]
    kv = keys[order]
    bits = kv ^ np.where(kv >> 31, np.uint32(0x80000000),
                         np.uint32(0xFFFFFFFF))
    vals = np.full(k, -np.inf, np.float32)
    ids = np.zeros(k, np.int64)
    vals[:len(order)] = bits.astype(np.uint32).view(np.float32)
    ids[:len(order)] = order
    if len(order) < k:
        neg = np.flatnonzero(row == -np.inf)
        ids[len(order):] = min(neg.min() if len(neg) else INT_MAX,
                               order.min() if len(order) else INT_MAX)
    return vals, ids


def _tie_rows(v, k, seed):
    """_inf_rows, then rows tied at the k-th value, of a few distinct
    values, and with equal values spread over every digit pass."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([_inf_rows(v, seed), rng.randn(3, v).astype(
        np.float32)])
    kth = np.sort(x[9])[::-1][min(k, v) - 1]
    x[9, rng.randint(0, v, size=v // 4)] = kth
    x[10] = rng.randint(0, 4, size=v).astype(np.float32)
    x[11] = np.float32(1.0) + np.float32(2.0 ** -20) * rng.randint(
        0, 8, size=v).astype(np.float32)
    return x


@pytest.mark.parametrize("v,k", [(61, 33), (150, 40), (61, 61), (5049, 33),
                                 (5049, 48), (5049, 64), (300, 300)])
def test_topk_wide_design_matches_the_twin(v, k):
    """csrc/topk.cu's k > 32 kernel (a radix select), emulated step by
    step, gives the twin's values and indices exactly: ties at the k-th
    value, equal values, +inf, too few entries above -inf, all -inf, k =
    v."""
    x = _tie_rows(v, k, v + k)
    want_v, want_i = ptk.topk_plain(t(x), k)
    for r in range(len(x)):
        got_v, got_i = _radix_select(x[r], k)
        np.testing.assert_array_equal(got_i, want_i[r].numpy())
        np.testing.assert_array_equal(got_v, want_v[r].numpy())


@pytest.mark.parametrize("k", [33, 64, 5049])
def test_topk_wide_design_skips_nan(k):
    """The same emulation on rows with NaNs (which the twin's amax cannot
    order) against C1's rule with NaN left out (``c1_topk``): NaN never
    chosen, the -inf rule past the last entry above -inf, an all-NaN row
    taking index 2**31 - 1."""
    from tests.torch_port_common import c1_topk

    rng = np.random.RandomState(k)
    x = rng.randn(5, 5049).astype(np.float32)
    x[0, ::3] = np.nan
    x[1] = np.nan
    x[1, [5, 9, 4000]] = [1.0, -np.inf, -2.0]
    x[2] = np.nan
    x[3, :100] = np.nan
    x[3, 100:] = -np.inf
    x[3, 2000] = 3.0
    x[4, 1::2] = np.nan
    want_v, want_i = c1_topk(x, k)
    for r in range(len(x)):
        got_v, got_i = _radix_select(x[r], k)
        np.testing.assert_array_equal(got_i, want_i[r])
        np.testing.assert_array_equal(got_v, want_v[r])


@pytest.mark.parametrize("k,sp", [(10, 15), (22, 33), (17, 4)])
def test_beam_update_wide_rounds_match_the_twin(k, sp):
    """csrc/beam_update.cu's block kernel: the weights in the unfused
    step's fp32 order, its top-k emulated (``wide_topk``: each chunk's
    bitonic sort, the lists' places, the -inf rule), and each hypothesis' token,
    ancestor, slot, psi and score from round r's candidate give the twin's
    (a lane whose candidates are all -inf runs the -inf rule)."""
    case = beam_step_case(k + sp, 9, b=7, k=k, sp=sp, eos=49)
    case["score"][6, :] = -np.inf
    case["score"][5, 1] = -np.inf
    kw = dict(w_dec=0.9, w_ctc=0.1, eos=49, neg=-1.0e30, d_end=-10.0,
              m_end=3)
    want = pbu.beam_update_plain(9, *(t(x) for x in case.values()), **kw)
    f32 = np.float32
    c = sp + 1
    for b in range(7):
        lane_active = not case["stop"][b] and 9 < case["xlens"][b]
        w = np.zeros(k * c, np.float32)
        tok = np.zeros(k * c, np.int64)
        psi = np.zeros(k * c, np.float32)
        for f in range(k * c):
            j, q = divmod(f, c)
            eos_slot = q == sp
            dec = case["dec_eos"][b, j] if eos_slot else case["dec_top"][b, j, q]
            psi[f] = case["psi_eos"][b, j] if eos_slot else case["psi_cand"][b, j, q]
            wv = f32(kw["w_dec"]) * dec + f32(kw["w_ctc"]) * (
                psi[f] - case["ctc_s"][b, j])
            if eos_slot and (case["part_ids"][b, j] == 49).any():
                wv = f32(kw["neg"])
            wv = wv + case["score"][b, j]
            if not case["alive"][b, j]:
                wv = f32(kw["neg"])
            w[f] = wv
            tok[f] = 49 if eos_slot else case["part_ids"][b, j, q]
        sel = [(f, top == -np.inf) for f, top in wide_topk(w, k)[0]]
        ids = [f for f, _ in sel]
        np.testing.assert_array_equal(tok[ids], want["token"][b].numpy())
        np.testing.assert_array_equal([f // c for f in ids],
                                      want["prev"][b].numpy())
        np.testing.assert_array_equal([f % c for f in ids],
                                      want["slot"][b].numpy())
        np.testing.assert_array_equal(psi[ids], want["psi_sel"][b].numpy())
        tops = [-np.inf if inf else w[f] for f, inf in sel]
        ended = [(tok[f] == 49 or 9 >= case["xlens"][b] - 1) and lane_active
                 for f in ids]
        score = [(f32(kw["neg"]) if e else s) if lane_active
                 else case["score"][b, r]
                 for r, (s, e) in enumerate(zip(tops, ended))]
        np.testing.assert_array_equal(np.float32(score),
                                      want["score"][b].numpy())
    assert (want["token"][6] == want["token"][6, 0]).all()  # the -inf rule


def test_topk_plain_k33_matches_jax():
    """The twin at the pre-beam of beam 22 (k = 33) against the JAX kernel
    in interpret mode, exactly, on rows with ties and the -inf rule."""
    from avsr_tpu.ops.pallas.topk import topk_lastdim

    x = np.concatenate([_inf_rows(5049, 3), np.random.RandomState(4).randn(
        15, 5049).astype(np.float32)])
    want_v, want_i = topk_lastdim(jnp.asarray(x), 33, interpret=True)
    got_v, got_i = ptk.topk_lastdim(t(x), 33)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("k,sp", [(10, 15), (22, 33)])
def test_beam_update_plain_wide_matches_jax(k, sp):
    """The twin at beam 10 (160 candidates) and beam 22 (748) against the
    JAX kernel in interpret mode; fp32 scores within C14's 1 ulp (XLA
    contracts the weighting into an FMA)."""
    from avsr_tpu.ops.pallas.beam_update import beam_update

    case = beam_step_case(k, 17, k=k, sp=sp, eos=49)
    kw = dict(w_dec=0.9, w_ctc=0.1, eos=49, neg=-1.0e30, d_end=-10.0,
              m_end=3)
    want = beam_update(
        jnp.asarray(17, jnp.int32),
        *(jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
          for x in case.values()),
        penalty=0.0, lazy=True, interpret=True, **kw)
    got = pbu.beam_update(17, *(t(x) for x in case.values()), **kw)
    assert set(got) == set(want)
    for name, g in got.items():
        g, w = g.numpy(), np.asarray(want[name])
        if name in ("score", "best_score", "ended_best"):
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _combine(m, s, m2, s2):
    """The kernels' (max, shifted sum) monoid with its -3e38 guard."""
    mm = torch.maximum(m, m2)
    safe = mm.clamp_min(-3.0e38)
    return mm, s * torch.exp(m - safe) + s2 * torch.exp(m2 - safe)


def _decode_tiled(pos, q, kv, bias, lanes, heads, row, plan):
    """csrc/decode_attention.cu's order in torch: the step's row written
    into the cache and read from kv_row, only the rows s <= min(pos, S-1)
    scored, in the kernel's (s, j) order; query groups of
    ``plan.group_lanes`` each over the whole
    prefix; a rank's (m, l) folded over its chunks in order, the ranks'
    combined in rank order; q and the normalised p rounded to the cache
    dtype (with a bf16 cache p is a one-chunk rank's held exp(s - m_rank)
    times exp(m_rank - m) / den), the ranks' fp32 partial P.V summed in
    rank order."""
    n, s_max, c2 = kv.shape
    c, b = c2 // 2, n // lanes
    dh, pc = c // heads, min(pos, s_max - 1)
    cd = kv.dtype
    kv[:, pc] = row.to(cd)
    k4 = kv[:, :pc + 1].view(b, lanes, pc + 1, 2, heads, dh).float()
    k4 = k4.transpose(1, 2).reshape(b, plan.rows, 2, heads, dh)  # r = s K + j
    qq = q.to(cd).float().view(b, lanes, heads, dh)
    bb = bias[:, :, :pc + 1].reshape(b, 1, lanes, plan.rows)
    out = torch.zeros(b, heads, lanes, dh)
    for g in range(plan.groups):
        qs = slice(g * plan.group_lanes, min(lanes, (g + 1) * plan.group_lanes))
        sc = torch.einsum("bkhd,brhd->bhkr", qq[:, qs], k4[:, :, 0]) + bb[
            :, :, qs]
        m = torch.full(sc.shape[:-1], float("-inf"))
        den = torch.zeros(sc.shape[:-1])
        held = []  # a one-chunk rank's exp(s - m_rank) and m_rank
        for r in range(plan.cluster):
            m_r, l_r = torch.full_like(m, float("-inf")), torch.zeros_like(den)
            for ch in plan.rank_chunks(r):
                part = sc[..., ch.start:ch.stop]
                m_c = part.amax(dim=-1)
                e = torch.exp(part - m_c.clamp_min(-3.0e38)[..., None])
                m_r, l_r = _combine(m_r, l_r, m_c, e.sum(-1))
            held.append((e, m_r) if len(plan.rank_chunks(r)) == 1 else None)
            m, den = _combine(m, den, m_r, l_r)
        den = den.clamp_min(1e-30)[..., None]
        if cd == torch.float32:  # expf and IEEE division
            p = torch.exp(sc - m[..., None]) / den
        else:  # the held exp times exp(m_rank - m) / den, or exp(s - m) / den
            p = torch.exp(sc - m[..., None]) * (1 / den)
            for r, kept in enumerate(held):
                rr = plan.rank_rows(r)
                if kept is not None:
                    e, m_r = kept
                    p[..., rr.start:rr.stop] = e * (torch.exp(
                        m_r.clamp_min(-3.0e38) - m)[..., None] / den)
        p = p.to(cd).float()
        o = torch.zeros(b, heads, qs.stop - qs.start, dh)
        for r in range(plan.cluster):
            rr = plan.rank_rows(r)
            o = o + torch.einsum("bhkr,brhd->bhkd", p[..., rr.start:rr.stop],
                                 k4[:, rr.start:rr.stop, 1])
        out[:, :, qs] = o
    return out.permute(0, 2, 1, 3).reshape(n, c).to(q.dtype), kv


@pytest.mark.parametrize("pos", [0, 11, 63, 80])
@pytest.mark.parametrize("lanes", [9, 22, 40, 100])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [None, 16])
def test_decode_tiled_arithmetic_within_the_output_bound(pos, lanes,
                                                         cache_dtype, chunk):
    """More than 8 lanes (beams of 9 and more; 100 lanes: two query groups
    of 50): the kernel's order, with the launch plan's chunks or with
    chunks of 16 rows forced (two passes), against the twin within
    ``output_bound`` (ROADMAP C27), and the same cache."""
    from avsr_tpu_torch.ops.kernels import decode_attention as pda
    from tests.torch_port_common import decode_case

    q, kv, row, bias = decode_case(pos + lanes, b=2, k=lanes, pos=pos)
    q, kv, row, bias = t(q), t(kv).to(cache_dtype), t(row), t(bias)
    plan = pda.launch_plan(2, lanes, 4, 32, 64, pos, kv.element_size())
    assert plan.groups == (2 if lanes > pda.GROUP_LANES else 1)
    if chunk and plan.rows_per_rank > chunk:
        plan = plan._replace(tile=chunk, chunk=chunk)
        assert len(plan.rank_chunks(0)) > 1
    got, got_kv = _decode_tiled(pos, q, kv.clone(), bias, lanes, 4, row, plan)
    want, want_kv = pda.decode_attention(pos, q, kv.clone(), bias, lanes, 4,
                                         row)
    bnd = pda.output_bound(pos, q, kv, bias, lanes, 4, row)
    assert torch.equal(got_kv, want_kv)
    assert bool(((got - want).abs() <= bnd).all())


def test_wide_limits_are_the_sources():
    """The wrappers' limits and counts are the sources': decode_attention's
    one query tile (the wide count's limit) and query group, beam_update's
    warp kernel, top-k's list kernel and the radix select's shared
    memory."""
    from avsr_tpu_torch.ops.kernels import _build
    from avsr_tpu_torch.ops.kernels import decode_attention as pda

    src = (_build.CSRC_DIR / "decode_attention.cu").read_text()
    assert f"constexpr int kTileLanes = {pda.MAX_LANES};" in src
    assert f"constexpr int kGroupLanes = {pda.GROUP_LANES};" in src
    assert "decode_attention_wide_kernel" not in src
    src = (_build.CSRC_DIR / "beam_update.cu").read_text()
    assert f"constexpr int kMaxK = {pbu.MAX_K};" in src
    assert f"constexpr int kMaxCand = {pbu.MAX_CAND};" in src
    assert "k > kMaxK || k * (sp + 1) > kMaxCand" in src
    src = (_build.CSRC_DIR / "topk.cu").read_text()
    assert "if (k > kMaxK) {" in src
    assert f"constexpr int kMaxK = {ptk.MAX_K};" in src
    assert f"constexpr int kWideSmemMax = {ptk.WIDE_SMEM_MAX};" in src
    for v, k in ((5049, 33), (61, 61), (5049, 5049), (100, 64)):
        n = 1 << (k - 1).bit_length()
        assert ptk.wide_smem_bytes(v, k) == (v + 1) // 2 * 8 + 8 * n


@pytest.mark.parametrize("beam,fused,eos_boost", [(22, False, 0.0),
                                                  (22, True, 3.0),
                                                  (10, True, 0.0)])
def test_c28_beam_matches_jax(base, beam, fused, eos_boost, monkeypatch):
    """Beams of 22 (pre-beam 33 > 32; 748 candidates) and 10 (160
    candidates) decode as the JAX beam does, token for token, scores
    within 1e-4, at ctc_weight=0.1, each step's pre-beam through the fused
    top-k and CTC row gather; no kernel is launched on the CPU."""
    calls = gather_spy(monkeypatch)
    jrec, prec = _recognizers(base, eos_boost, beam_size=beam,
                              ctc_weight=0.1)
    prec = dataclasses.replace(prec, fused_bookkeeping=fused)
    batch = _batch(7)
    aud, vid, lens, _ = jrec._pad_batch(*batch)
    feats, ctc = jrec._encode_fn()(jrec.variables, aud, vid, lens)
    jy, jl, js = (np.asarray(x) for x in jrec._beam_fn()(
        jrec.variables, feats, ctc, lens))
    before = (ptk.topk_lastdim.launches, pbu.beam_update.launches)
    paud, pvid, plens, _ = prec._pad_batch(*batch)
    py, pl, ps = (x.numpy() for x in prec.beam(*prec.encode(paud, pvid, plens),
                                                 plens))
    assert (ptk.topk_lastdim.launches, pbu.beam_update.launches) == before
    assert len(calls) >= pl.max() - 2
    assert {shape[1:] for shape in calls} == {(beam, base[0].odim)}
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_allclose(ps, js, atol=1e-4, rtol=0)


# ---------------------------------------------------------------- Recognizer


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_async_matches_sync_and_jax(base, mode):
    jrec, prec = _recognizers(base, ctc_weight=0.1)
    audio, video = _batch(8)
    pending = prec.transcribe_batch_async(audio, video, mode=mode,
                                          batch_pad=4)
    got = pending.result()
    want = jrec.transcribe_batch_async(audio, video, mode=mode,
                                       batch_pad=4).result()
    sync = prec.transcribe_batch(audio, video, mode=mode, batch_pad=4)
    assert len(got) == len(want) == len(sync) == 3
    for g, w, s in zip(got, want, sync):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, s)
    np.testing.assert_array_equal(
        prec.transcribe(audio[1], video[1], mode=mode),
        np.asarray(jrec.transcribe(audio[1], video[1], mode=mode)))


def test_recognizer_audio_fields_match_jax():
    from avsr_tpu.decode.recognizer import Recognizer as JaxRecognizer
    from avsr_tpu_torch.decode.recognizer import Recognizer

    jf = {f.name: f.default for f in dataclasses.fields(JaxRecognizer)}
    pf = {f.name: f.default for f in dataclasses.fields(Recognizer)}
    assert (pf["audio_rate"], pf["audio_dim"]) == (
        jf["audio_rate"], jf["audio_dim"]) == (1, 104)


# ---------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A reference-format checkpoint directory (config.json and
    pytorch_model.bin, ``avsr.``-prefixed keys) written from the tiny JAX
    model, a toy tokenizer whose units cover the model's 61 ids, and mp4 +
    wav fixtures."""
    pytest.importorskip("cv2")
    from avsr_tpu.core.checkpoint import avsr_mapping, flax_to_torch

    setup_torch()
    root = tmp_path_factory.mktemp("eval")
    ckpt = root / "ckpt"
    ckpt.mkdir()
    cfg = tiny_cfg()
    _, variables = jax_tiny_model(cfg, seed=3)
    state = flax_to_torch(variables, avsr_mapping(cfg))
    torch.save({k: torch.from_numpy(np.array(v, np.float32))
                for k, v in state.items()}, str(ckpt / "pytorch_model.bin"))
    cfg.to_json(str(ckpt / "config.json"))
    tok = root / "spm"
    tok.mkdir()
    write_toy_tokenizer(str(tok), n_units=cfg.odim - 2)
    media = root / "media"
    media.mkdir()
    videos = []
    for i, frames in enumerate((30, 22, 41, 60)):
        path = str(media / f"utt{i}.mp4")
        write_fixture(path, frames, seed=i)
        videos.append(path)
    return dict(ckpt=str(ckpt), tok=str(tok), videos=videos, root=root)


def _engines(assets, **kw):
    from avsr_tpu.cli import evaluation as je
    from avsr_tpu_torch.cli import evaluation as pe

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtok, "_DEFAULT_ASSET_DIRS", (assets["tok"],))
        mp.setattr(ptok, "_DEFAULT_ASSET_DIRS", (assets["tok"],))
        kw = dict(dict(checkpoint_path=assets["ckpt"], batch_size=2), **kw)
        jeng = je.InferenceEngine(**kw)
        peng = pe.InferenceEngine(device="cpu", **kw)
        jeng.load_model()
        peng.load_model()
    return jeng, peng


@pytest.fixture(scope="module")
def engines(assets):
    return _engines(assets, model_kwargs=dict(FP32))


def _lrs2_dataset(videos):
    labels = [b"HELLO WORLD", b"THE LAZY DOG", "A QUICK TEST", b"FOX"]
    ds = []
    for path, label in zip(videos, labels):
        with open(path, "rb") as f, open(path[:-4] + ".wav", "rb") as g:
            ds.append({"video": f.read(), "audio": g.read(), "label": label})
    return ds


def test_eval_lrs2_matches_jax(engines, assets, tmp_path, monkeypatch):
    """Transcripts and WER over bytes samples with wav sidecars, in chunks
    of two (the producer thread and its queue); the temp mp4 and wav of
    every sample are removed."""
    import tempfile

    from avsr_tpu.cli import evaluation as je
    from avsr_tpu_torch.cli import evaluation as pe

    pin_fbank_route(monkeypatch)
    jeng, peng = engines
    ds = _lrs2_dataset(assets["videos"])
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    samples = [{"video": s["video"], "audio": s["audio"]} for s in ds]
    got = peng.infer_samples(samples)
    assert got == jeng.infer_samples(samples)
    assert len(got) == 4 and all(isinstance(x, str) for x in got)
    assert pe.eval_lrs2(peng, ds) == je.eval_lrs2(jeng, ds)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("chunking", ["fixed", "asd"])
def test_infer_video_matches_jax(engines, assets, tmp_path, monkeypatch,
                                 chunking):
    """A 2.4 s video in 1 s chunks: fixed windows over the audio's length,
    or the ASD scores' segments (two chunks of a 2 s active region)."""
    pin_fbank_route(monkeypatch)
    jeng, peng = engines
    for eng in engines:
        monkeypatch.setattr(eng, "max_length", 1)
    asd_path = None
    if chunking == "asd":
        asd_path = str(tmp_path / "asd.json")
        with open(asd_path, "w") as f:
            json.dump({str(100 + i): (2.0 if i < 50 else -2.0)
                       for i in range(60)}, f)
    path = assets["videos"][3]
    got = peng.infer_video(path, asd_path, offset=5.0)
    assert got == jeng.infer_video(path, asd_path, offset=5.0)
    assert len(got) >= 2


def test_eval_avcocktail_matches_jax(engines, assets, monkeypatch):
    """Each chunk type's WER and the label's word count, on segments that
    the labels' span keeps and one that it drops."""
    from avsr_tpu.cli import evaluation as je
    from avsr_tpu_torch.cli import evaluation as pe

    pin_fbank_route(monkeypatch)
    v = assets["videos"]
    video_ds = {
        "asd_chunk": [{"video": v[0], "start_time": 1.0, "end_time": 2.2},
                      {"video": v[1], "start_time": "0.0",
                       "end_time": "0.9"}],
        "fixed_chunk": [{"video": v[2], "start_time": b"0.5",
                         "end_time": b"2.0"},
                        {"video": v[3], "start_time": 30.0,
                         "end_time": 31.0}],
        "gold_chunk": [{"video": v[1], "start_time": 0.2, "end_time": 1.0}],
    }
    labels = {"label": ["WEBVTT\n\n00:00:00.500 --> 00:00:01.500\nHELLO "
                        "WORLD\n\n00:00:01.600 --> 00:00:02.500\nTHE LAZY "
                        "DOG\n"]}
    got = pe.eval_avcocktail(engines[1], video_ds, labels, "video_0")
    assert got == je.eval_avcocktail(engines[0], video_ds, labels, "video_0")
    assert got[1] == 5 and set(got[0]) == set(pe.CHUNK_TYPES)


def test_mcorec_session_matches_jax(engines, assets, tmp_path, monkeypatch):
    """Speaker clustering (speaker_to_cluster.json) and each speaker's VTT
    of a two-speaker session."""
    pytest.importorskip("sklearn")
    import shutil

    pin_fbank_route(monkeypatch)
    session = tmp_path / "session"
    session.mkdir()
    metadata = {}
    for spk, src, base in (("alice", assets["videos"][2], 0),
                           ("bob", assets["videos"][3], 30)):
        shutil.copy(src, session / f"{spk}.mp4")
        shutil.copy(src[:-4] + ".wav", session / f"{spk}.wav")
        with open(session / f"{spk}_asd.json", "w") as f:
            json.dump({str(base + i): 2.0 for i in range(30)}, f)
        with open(session / f"{spk}_crop.json", "w") as f:
            json.dump({"start_time": 0.5}, f)
        metadata[spk] = {"central": {
            "crops": [{"lip": f"{spk}.mp4", "asd": f"{spk}_asd.json",
                       "crop_metadata": f"{spk}_crop.json"}],
            "uem": {"start": 0.0, "end": 3.0}}}
    with open(session / "metadata.json", "w") as f:
        json.dump(metadata, f)
    outs = []
    for eng, name in zip(engines, ("jax", "port")):
        out = tmp_path / name
        eng.mcorec_session_infer(str(session), str(out))
        outs.append({p: (out / p).read_text() for p in sorted(os.listdir(out))})
    assert outs[1] == outs[0]
    assert sorted(outs[1]) == ["alice.vtt", "bob.vtt",
                               "speaker_to_cluster.json"]


def test_producer_error_names_the_segment(engines, capsys):
    """A sample that fails to decode in the producer thread reaches the
    caller, after the segment is named."""
    _, peng = engines
    with pytest.raises(IOError):
        peng.infer_samples([{"video": "missing.mp4", "start_time": 0.5}])
    out = capsys.readouterr().out
    assert "Error during inference for segment {'video': 'missing.mp4', " \
           "'start_time': 0.5}" in out


def test_bf16_engine_matches_jax_on_a_pinned_input(assets, monkeypatch):
    """The CLI's defaults, bf16 decoder weights and K|V cache, on both
    sides. Near-ties decide differently in the two frameworks' bf16
    roundings (ROADMAP C13): on these random tiny weights most fixtures'
    transcripts differ in bf16, while all agree in fp32
    (test_eval_lrs2_matches_jax). So the input is pinned to the 60-frame
    fixture, whose bf16 transcripts agree."""
    pin_fbank_route(monkeypatch)
    jeng, peng = _engines(assets)
    for eng in (jeng, peng):
        cfg = eng.recognizer.cfg
        assert cfg.decoder_param_dtype == cfg.decoder_cache_dtype == "bfloat16"
    samples = [{"video": assets["videos"][3]}]
    assert peng.infer_samples(samples) == jeng.infer_samples(samples)


def test_build_parser_matches_jax():
    """Every flag, default, type and choice of the JAX CLI, plus the port's
    ``--device``."""
    from avsr_tpu.cli.evaluation import build_parser as jax_parser
    from avsr_tpu_torch.cli.evaluation import build_parser

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         None if a.choices is None else tuple(a.choices),
                         a.nargs, a.const)
                for a in parser._actions}

    port = flags(build_parser())
    # the port's own flag: the torch device, the card by default
    assert port.pop("device") == (("--device",), "cuda", str, None, None,
                                  None)
    assert port == flags(jax_parser())
    args = build_parser().parse_args(["--beam_size", "22", "--set_id",
                                      "video_3", "--dataset_name",
                                      "AVCocktail"])
    assert (args.beam_size, args.set_id, args.batch_size) == (22, "video_3",
                                                              32)


def test_engine_defaults_match_jax():
    from avsr_tpu.cli.evaluation import InferenceEngine as JaxEngine
    from avsr_tpu_torch.cli.evaluation import InferenceEngine

    jp = inspect.signature(JaxEngine).parameters
    pp = inspect.signature(InferenceEngine).parameters
    assert list(pp) == list(jp) + ["device"]
    assert all(pp[n].default == jp[n].default for n in jp)
    assert pp["device"].default == "cuda"


@pytest.mark.parametrize("model_type,item", [("muavic_en", "A8")])
def test_unported_model_types_raise(model_type, item):
    from avsr_tpu_torch.cli.evaluation import InferenceEngine

    with pytest.raises(NotImplementedError, match=item):
        InferenceEngine(model_type, device="cpu").load_model()


def test_eval_path_imports_no_jax(assets):
    """Importing the CLI and running the engine (the tokenizer found
    through AVSR_SPM_DIR, two mp4s with their wav sidecars, media decode,
    fbank, collation and the beam) loads nothing of the JAX package, JAX,
    flax or ml_dtypes."""
    code = f"""
import sys
from avsr_tpu_torch.cli import evaluation as pe
eng = pe.InferenceEngine(checkpoint_path={assets['ckpt']!r}, batch_size=2,
                         device="cpu", model_kwargs={FP32!r})
eng.load_model()
out = eng.infer_samples([{{"video": {assets['videos'][1]!r}}},
                         {{"video": {assets['videos'][2]!r}}}])
assert len(out) == 2 and all(isinstance(x, str) for x in out), out
bad = [m for m in sys.modules
       if m.split('.')[0] in ('avsr_tpu', 'jax', 'flax', 'ml_dtypes')]
assert not bad, bad
"""
    env = dict(os.environ, AVSR_SPM_DIR=assets["tok"])
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env=env)
