"""The port's CTC prefix scorer, its kernel twins and its own copies of the
config and weight mapping, against the JAX package (CPU; the Pallas
kernels in interpret mode, as the JAX package's own tests run them).

Tolerances: ``cumlogsumexp_plain`` runs the TPU kernel's Kogge-Stone tree,
so it agrees with it to fp32 rounding (rtol 1e-6, atol 1e-5; -inf exactly).
The scorer sums with ``torch.cumsum`` where the JAX package contracts with
a tril matmul, so its outputs agree to atol 1e-4, rtol 1e-6. Gathers and
selections are exact. ``beam_update_plain`` equals the JAX kernel exactly,
except that XLA's CPU backend contracts ``w_dec*a + w_ctc*b`` into one
fused multiply-add where torch rounds each product: with weights 0.9/0.1
on random scores the fp32 sums can then differ by one ulp (every
selection, id, count and mask still equal exactly); on a 1/64 grid with
weights 0.75/0.25 every order is exact and so are all outputs.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from avsr_tpu.decode import ctc_prefix as jctc  # noqa: E402
from avsr_tpu_torch.decode import ctc_prefix as pctc  # noqa: E402
from avsr_tpu_torch.ops.kernels import beam_update as pbu  # noqa: E402
from avsr_tpu_torch.ops.kernels import row_gather as prg  # noqa: E402
from avsr_tpu_torch.ops.kernels import scan_logsumexp as psl  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    beam_step_case,
    port_cfg,
    setup_torch,
    t,
    tiny_cfg,
)


@pytest.fixture(autouse=True, scope="module")
def _torch():
    setup_torch()


# ---------------------------------------------------------- cumlogsumexp


@pytest.mark.parametrize("tt", [1, 7, 24, 128, 375])
def test_cumlogsumexp_plain_matches_jax(tt):
    """Random columns, columns with a -inf prefix, all -inf columns."""
    from avsr_tpu.ops.pallas.scan_logsumexp import cumlogsumexp

    rng = np.random.RandomState(tt)
    x = (rng.randn(tt, 6, 5) * 3.0).astype(np.float32)
    x[: tt // 2, 1] = -np.inf  # -inf prefixes
    x[: tt - 1, 2, :2] = -np.inf  # finite only in the last row
    x[:, 3] = -np.inf  # all -inf
    want = np.asarray(cumlogsumexp(jnp.asarray(x)))
    got = psl.cumlogsumexp(t(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(want).any() and not np.isnan(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-5)


def test_cumlogsumexp_plain_monotone_drift_depth():
    """Terms drifting 8.5 nats a frame over T=375 (far beyond the fp32 exp
    range, as the CTC terms do): every prefix keeps its own precision.
    Held against a float64 numpy scan."""
    tt = 375
    rng = np.random.RandomState(0)
    x = (-8.5 * np.arange(tt)[::-1] + rng.randn(tt)).astype(np.float32)
    x = x[:, None, None] + np.zeros((1, 2, 3), np.float32)
    got = psl.cumlogsumexp(t(x)).numpy()
    want = np.logaddexp.accumulate(x.astype(np.float64), axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# ------------------------------------------------------------ row_gather


def test_row_gather_plain_matches_jax():
    from avsr_tpu.ops.pallas.row_gather import row_gather

    rng = np.random.RandomState(3)
    src = rng.randn(5 * 61, 128).astype(np.float32)
    idx = rng.randint(0, src.shape[0], size=36)
    idx[:3] = [0, src.shape[0] - 1, idx[5]]  # edges and a repeat
    want = np.asarray(row_gather(jnp.asarray(src), jnp.asarray(idx, jnp.int32)))
    got = prg.row_gather(t(src), t(idx.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_topk_gather_rows_matches_jax_topk_and_row_gather():
    """The fused pre-beam top-k and CTC row gather (its CPU route) gives
    the JAX package's ``topk_lastdim`` followed by its ``row_gather`` of
    rows b*V + id: the same values and ids, the same rows bit for bit, on
    rows with ties at the maximum and a row of equal values."""
    from avsr_tpu.ops.pallas.row_gather import row_gather
    from avsr_tpu.ops.pallas.topk import topk_lastdim
    from avsr_tpu_torch.ops.kernels import topk as ptk

    b, k, v, tp, n = 2, 3, 64, 128, 4
    rng = np.random.RandomState(13)
    x = rng.randn(b, k, v).astype(np.float32)
    x[..., v // 2] = x.max(axis=-1)
    x[..., -1] = x.max(axis=-1)
    x[1, 2] = 0.5
    table = rng.randn(b * v, tp).astype(np.float32)
    want_v, want_i = topk_lastdim(jnp.asarray(x), n)
    idx = np.asarray(want_i) + (np.arange(b) * v)[:, None, None]
    want_rows = row_gather(jnp.asarray(table),
                           jnp.asarray(idx.reshape(-1), jnp.int32))
    got_v, got_i, got_rows = ptk.topk_gather_rows(t(x), n, t(table))
    assert got_rows.shape == (b * k * n, tp)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    assert (got_i[1, 2].numpy() == np.arange(n)).all()  # equal values


# ---------------------------------------------------------- CTC scorer


def _scorer_case(seed, out_len, eos=24, v=25, t_max=40, k=3, s=4):
    """Padded log-probs of three utterances of mixed length, a prefix state
    and pre-beam ids with eos and each hypothesis's last token among them."""
    rng = np.random.RandomState(seed)
    xlens = np.asarray([40, 33, 17])
    b = len(xlens)
    logp = np.log(rng.dirichlet(np.ones(v), size=(b, t_max))).astype(np.float32)
    part_ids = rng.randint(1, v - 1, size=(b, k, s))
    last = rng.randint(1, v - 1, size=(b, k))
    part_ids[0, 0, 1] = eos
    part_ids[1, 2, 3] = eos
    part_ids[:, 1, 0] = last[:, 1]  # the prefix's last token: phi = r_b
    part_ids[2, 0, 2] = 0  # blank: never selectable
    r = (-np.abs(rng.randn(b, k, t_max, 2)) * 5.0).astype(np.float32)
    state = dict(r=r, s=rng.randn(b, k).astype(np.float32), last=last,
                 out_len=np.asarray(out_len))
    return logp, xlens, part_ids, state


def _jax_state(st):
    return jctc.CTCPrefixState(
        r=jnp.asarray(st["r"]), s=jnp.asarray(st["s"]),
        last=jnp.asarray(st["last"], jnp.int32),
        out_len=jnp.asarray(st["out_len"], jnp.int32))


def _port_state(st):
    return pctc.CTCPrefixState(r=t(st["r"]), s=t(st["s"]),
                               last=t(st["last"].astype(np.int64)),
                               out_len=t(st["out_len"].astype(np.int64)))


def test_pad_log_probs_and_init_state_match_jax():
    logp, xlens, _, _ = _scorer_case(0, [0, 0, 0])
    want = jax.vmap(jctc.pad_log_probs, in_axes=(0, 0))(
        jnp.asarray(logp), jnp.asarray(xlens, jnp.int32))
    got = pctc.pad_log_probs(t(logp), t(xlens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jst = jax.vmap(jctc.init_state, in_axes=(0, None, None))(want, 3, 24)
    pst = pctc.init_state(got, 3, 24)
    np.testing.assert_allclose(pst.r.numpy(), np.asarray(jst.r), rtol=1e-6,
                               atol=1e-4)
    for name in ("s", "last", "out_len"):
        np.testing.assert_array_equal(getattr(pst, name).numpy(),
                                      np.asarray(getattr(jst, name)))


@pytest.mark.parametrize("out_len", [[0, 0, 0], [0, 2, 5], [3, 1, 12]])
def test_score_candidates_cols_batched_matches_jax(out_len):
    logp, xlens, part_ids, st = _scorer_case(sum(out_len), out_len)
    jlogp = jax.vmap(jctc.pad_log_probs, in_axes=(0, 0))(
        jnp.asarray(logp), jnp.asarray(xlens, jnp.int32))
    plogp = pctc.pad_log_probs(t(logp), t(xlens))
    # (T, B, K, S) candidate columns, gathered on the host for both sides
    lp = np.asarray(jlogp)
    xs = np.take_along_axis(lp[:, :, None, None, :],
                            part_ids[:, None, :, :, None], axis=-1)[..., 0]
    xs = np.ascontiguousarray(np.transpose(xs, (1, 0, 2, 3)))
    want = jctc.score_candidates_cols_batched(
        jnp.asarray(xs), jnp.cumsum(jlogp[:, :, 0], axis=1),
        jnp.asarray(xlens, jnp.int32), _jax_state(st),
        jnp.asarray(part_ids, jnp.int32), 24, 0)
    got = pctc.score_candidates_cols_batched(
        t(xs), torch.cumsum(plogp[:, :, 0], dim=1), t(xlens), _port_state(st),
        t(part_ids.astype(np.int64)), 24, 0)
    for name, g, w in zip(("psi_cand", "psi_eos", "r_cands"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-4, err_msg=name)
    assert (got[0].numpy()[2, 0, 2] == pctc.LOG_ZERO)  # blank
    np.testing.assert_array_equal(got[0].numpy()[0, 0, 1], got[1].numpy()[0, 0])


def test_select_candidates_matches_jax():
    """The new state of selected (prev, slot) pairs, the eos slot (S)
    clamped to S-1; exact."""
    rng = np.random.RandomState(5)
    b, k, s, tt = 3, 3, 4, 24
    r_cands = rng.randn(b, k, s, tt, 2).astype(np.float32)
    prev = rng.randint(0, k, size=(b, k))
    slot = rng.randint(0, s + 1, size=(b, k))
    slot[0, 0] = s
    token = rng.randint(1, 20, size=(b, k))
    psi_sel = rng.randn(b, k).astype(np.float32)
    st = dict(r=np.zeros((b, k, tt, 2), np.float32),
              s=np.zeros((b, k), np.float32), last=np.zeros((b, k), np.int64),
              out_len=np.asarray([0, 3, 7]))
    want = jax.vmap(jctc.select_candidates)(
        _jax_state(st), jnp.asarray(psi_sel), jnp.asarray(r_cands),
        jnp.asarray(prev, jnp.int32), jnp.asarray(slot, jnp.int32),
        jnp.asarray(token, jnp.int32))
    got = pctc.select_candidates(_port_state(st), t(psi_sel), t(r_cands),
                                 t(prev), t(slot), t(token))
    for name in ("r", "s", "last", "out_len"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


# ----------------------------------------------------------- beam_update


def _jax_beam_update(i, case, kw):
    from avsr_tpu.ops.pallas.beam_update import beam_update

    args = [None if x is None else
            jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
            for x in case.values()]
    return beam_update(jnp.asarray(i, jnp.int32), *args, penalty=0.0,
                       lazy=True, **kw)


@pytest.mark.parametrize("w_ctc,dyadic", [(0.25, True), (0.0, False),
                                          (0.0, True), (0.1, False)])
@pytest.mark.parametrize("seed,i", [(0, 4), (1, 9), (2, 17)])
def test_beam_update_plain_matches_jax(seed, i, w_ctc, dyadic):
    """Random step states: a forced last step, a stopped lane, a lane past
    its length, eos among the pre-beam ids with end detection, ties across
    hypotheses and a dead hypothesis (see beam_step_case)."""
    case = beam_step_case(seed, i, use_ctc=w_ctc > 0, dyadic=dyadic)
    kw = dict(w_dec=1.0 - w_ctc, w_ctc=w_ctc, eos=49, neg=-1.0e30,
              d_end=-10.0, m_end=3)
    want = _jax_beam_update(i, case, kw)
    got = pbu.beam_update(i, *(None if x is None else t(x)
                               for x in case.values()), **kw)
    assert set(got) == set(want)
    # the cases run every path: forced, stopped, ended, tied
    assert got["stop"].numpy()[[0, 1]].all()
    assert (got["token"].numpy() == 49).any()
    for name, g in got.items():
        g, w = g.numpy(), np.asarray(want[name])
        if name in ("score", "best_score", "ended_best") and not dyadic:
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_beam_update_plain_equals_unfused_step():
    """The twin against the port's unfused beam step, bit for bit: one
    step of beam_search_batched with a stub decoder, run both ways."""
    from avsr_tpu_torch.decode.beam import BeamSearchConfig, beam_search_batched

    rng = np.random.RandomState(11)
    b, t_max, v = 3, 12, 30
    feats = torch.zeros(b, t_max, 4)
    ctc = torch.log_softmax(t(rng.randn(b, t_max, v).astype(np.float32)), -1)
    logits = t(rng.randn(t_max + 2, b * 3, v).astype(np.float32))

    def step(y, pos, cache, mem_mask, lane_bias):
        # a decoder whose scores depend on the step and the fed token
        return torch.log_softmax(logits[pos] + 0.5 * (y[:, None] % 7), -1), cache

    outs = []
    for fused in (False, True):
        cfg = BeamSearchConfig(ctc_weight=0.3, sos=v - 1, eos=v - 1, vocab=v,
                               fused_bookkeeping=fused, shared_src_kv=True,
                               lazy_reorder=True)
        outs.append(beam_search_batched(cfg, step, lambda *a: None, feats,
                                        ctc, torch.tensor([12, 7, 10])))
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


# ------------------------------------------- the port's config and mapping


def _configs():
    from avsr_tpu.core.config import AVHubertAVSRConfig

    return {"tiny": tiny_cfg(), "flagship": AVHubertAVSRConfig()}


@pytest.mark.parametrize("name", ["tiny", "flagship"])
def test_port_config_matches_jax(name, tmp_path):
    from avsr_tpu.core import config as jconfig
    from avsr_tpu_torch.core import config as pconfig

    jcfg = _configs()[name]
    pcfg = port_cfg(jcfg)
    assert pcfg.to_dict() == jcfg.to_dict()
    for prop in ("sos", "eos", "blank", "ignore_id"):
        assert getattr(pcfg, prop) == getattr(jcfg, prop)
    assert pcfg.encoder.fused_dim == jcfg.encoder.fused_dim
    jcfg.to_json(str(tmp_path / "c.json"))
    assert pconfig.AVHubertAVSRConfig.from_json(str(tmp_path / "c.json")) == pcfg
    for cls in ("AVHubertAVSRConfig", "AVHubertEncoderConfig"):
        jf = [(f.name, f.type, f.default) for f in
              dataclasses.fields(getattr(jconfig, cls))
              if f.name != "encoder"]
        pf = [(f.name, f.type, f.default) for f in
              dataclasses.fields(getattr(pconfig, cls))
              if f.name != "encoder"]
        assert pf == jf, cls


@pytest.mark.parametrize("name", ["tiny", "flagship"])
def test_port_mapping_matches_jax(name):
    """Every entry of avsr_mapping (torch keys, flax path, collection) and
    its transform and inverse on random arrays; flax_to_torch on random
    variables; the key normalisation and the ignorable suffixes."""
    from avsr_tpu.core import checkpoint as jck
    from avsr_tpu_torch.core import checkpoint as pck

    jcfg = _configs()[name]
    rng = np.random.RandomState(0)
    rank = {"_dense": 2, "_conv2d": 4, "_conv3d": 5, "_copy": 1}
    jmap = jck.avsr_mapping(jcfg, prefix="avsr.")
    pmap = pck.avsr_mapping(port_cfg(jcfg), prefix="avsr.")
    assert len(pmap) == len(jmap)
    variables = {"params": {}, "batch_stats": {}}
    for (pk, pp, ptr, pc), (jk, jp, jtr, jc) in zip(pmap, jmap):
        assert (pk, pp, pc, ptr.__name__) == (jk, jp, jc, jtr.__name__)
        x = rng.randn(*(2, 3, 4, 5, 6)[: rank[ptr.__name__]]).astype(np.float32)
        np.testing.assert_array_equal(ptr(x), jtr(x))
        y = jtr(x)
        np.testing.assert_array_equal(pck._inverse_transform(ptr)(y),
                                      jck._inverse_transform(jtr)(y))
        leaf = np.stack([y] * len(jk)) if isinstance(jk, list) else y
        node = variables["params" if jc == "p" else "batch_stats"]
        for part in jp[:-1]:
            node = node.setdefault(part, {})
        node[jp[-1]] = leaf
    want = jck.flax_to_torch(variables, jmap)
    got = pck.flax_to_torch(variables, pmap)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert pck._IGNORABLE_SUFFIXES == jck._IGNORABLE_SUFFIXES
    keys = {"a.parametrizations.weight.original0": 1,
            "a.parametrizations.weight.original1": 2, "b.weight": 3}
    assert pck.normalize_torch_keys(keys) == jck.normalize_torch_keys(keys)
