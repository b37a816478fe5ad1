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
from avsr_tpu_torch.ops.kernels import topk as ptk  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    beam_step_case, decode_case, setup_torch, t)

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


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "k",
                                  "scan_dtype", "gather_index_dtype",
                                  "gather_rank", "update_shape",
                                  "update_ctc_operands"])
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
        elif case == "update_shape":
            args = _step_args()
            args[10] = args[10][:, :, :-1]  # yseq one column short
            pbu.beam_update(5, *args, **BU_KW)
        else:
            args = _step_args()
            args[4] = None  # psi_eos without psi_cand's partners
            pbu.beam_update(5, *args, **BU_KW)
