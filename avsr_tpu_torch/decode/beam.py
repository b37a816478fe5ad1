"""Batched joint CTC/attention beam search and greedy CTC.

Counterpart of ``avsr_tpu/decode/beam.py`` (``beam_search_batched`` and
``greedy_ctc``). The utterances of a batch decode together: beam slots are
fixed tensors, the decoder runs incrementally over per-layer K|V caches,
ended hypotheses retire by masking, and the reference's end detection
(e2e_asr_common.py:18) and forced final eos are kept. As the JAX
package's ``lax.while_loop``, the search is a state of fixed-shape device
tensors (``BeamState``, the step index among them) and a step function
(``beam_step``, JAX's ``body``) that reads the step index only on the
device; ``decode/device_loop.py`` runs it, reading the stop flag once
every k steps and, on the card, replaying k steps at a time as a CUDA
graph.

Two switches keep the JAX names and defaults (both off), but the port
serves only the two settings its decoders take, so they must agree
(``beam_search_batched`` raises otherwise). Both on (the ``Recognizer``,
as the JAX one): the decoder keeps the source K/V once an utterance
(``decoder_init(memory, maxlen, beam)``) and never reshuffles its self
caches; each lane's ancestry is resolved at attention time through an
additive ``lane_bias`` (``decoder_step(y, pos, cache, mem_mask,
lane_bias)``). Both off (``S2TGenerator``): the memory is repeated to B*K
lanes (``decoder_init(memory, maxlen)``), the step takes no
``lane_bias``, and the self caches (``self_k`` and ``self_v`` of a
``_replace``-able cache, as ``S2TDecoderCache``) are gathered by each
successor's parent after the selection.

Scoring follows the reference's get_beam_search_decoder: decoder weight
1 - ctc_weight, CTC prefix score (``decode/ctc_prefix.py``) weight
ctc_weight, pre-beam of 1.5 x beam on the decoder scores, length bonus 0.
With ``fused_bookkeeping`` the step's bookkeeping after scoring runs as one
kernel (``ops/kernels/beam_update.py``), bit-identical to the unfused ops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from avsr_tpu_torch.decode import ctc_prefix
from avsr_tpu_torch.decode import device_loop as device_loop_mod
from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.kernels.beam_update import beam_update
from avsr_tpu_torch.ops.kernels.topk import topk_gather_rows, topk_lastdim

NEG = -1.0e30
D_END = -10.0  # log(1 * exp(-10)), e2e_asr_common.py:18
M_END = 3


@dataclass(frozen=True)
class BeamSearchConfig:
    beam_size: int = 3
    ctc_weight: float = 0.1
    sos: int = 5048
    eos: int = 5048
    blank: int = 0
    vocab: int = 5049
    # self-KV buffer cap in tokens (None = frame-count-sized)
    max_decode_tokens: Optional[int] = None
    # the bookkeeping after scoring as one beam_update kernel launch a step
    # instead of ~100 small ops; the same results bit for bit
    fused_bookkeeping: bool = False
    # source K/V once an utterance, not repeated to its K lanes; and self
    # caches never reshuffled, ancestry resolved through lane_bias. Set
    # both or neither.
    shared_src_kv: bool = False
    lazy_reorder: bool = False

    @property
    def pre_beam_size(self) -> int:
        return int(1.5 * self.beam_size)  # the reference's pre_beam_ratio


def reorder_cache(cache, prev: torch.Tensor):
    """The eager path's self-cache reshuffle: lane (b, k) takes the self
    K/V of lane (b, prev[b, k]). Finished lanes copy rows never read
    again."""
    b, k = prev.shape
    flat_prev = (torch.arange(b, device=prev.device)[:, None] * k
                 + prev).reshape(-1)
    return cache._replace(self_k=cache.self_k.index_select(1, flat_prev),
                          self_v=cache.self_v.index_select(1, flat_prev))


class BeamState(NamedTuple):
    """The search's state between steps: fixed-shape tensors on the
    device, as the JAX package's ``BeamState``, so that the step can be
    captured once and replayed."""

    i: torch.Tensor  # (1,) int32 step, which the kernels read on the device
    yseq: torch.Tensor  # (B, K, L) token buffer, sos at [..., 0]
    score: torch.Tensor  # (B, K)
    alive: torch.Tensor  # (B, K) bool
    anc: torch.Tensor  # (kv_len, B, K) lazy-reorder ancestry; (1, B, K)
    #                    unused on the eager path
    ended_best: torch.Tensor  # (B, L) best ended score per step
    ended_cnt: torch.Tensor  # (B, L) ended count per step
    best_score: torch.Tensor  # (B,)
    best_yseq: torch.Tensor  # (B, L)
    best_len: torch.Tensor  # (B,)
    stop: torch.Tensor  # (B,) bool
    ctc: Optional[ctc_prefix.CTCPrefixState]  # None without CTC
    cache: object  # the decoder's cache over the B*K lanes


class LoopInputs(NamedTuple):
    """What the step reads and never writes."""

    xlens: torch.Tensor  # (B,) int64
    mem_mask: torch.Tensor  # (B | B*K, 1, S) bool
    logp_rows: Optional[torch.Tensor]  # (B*V, Tp) the CTC table's rows
    cum_b: Optional[torch.Tensor]  # (B, Tp) the blank log-probs' cumsum


def init_search(cfg: BeamSearchConfig, decoder_init: Callable, feats,
                ctc_log_probs, xlens) -> Tuple[BeamState, LoopInputs]:
    """The state before step 0 and the loop's inputs."""
    dev = feats.device
    b, s_max = feats.shape[:2]
    k = cfg.beam_size
    v = cfg.vocab
    buf_len = s_max + 2
    kv_len = (min(buf_len, cfg.max_decode_tokens) if cfg.max_decode_tokens
              else buf_len)
    kv_len = -(-kv_len // 64) * 64  # the JAX kernel's aligned buffer length
    lazy = cfg.lazy_reorder
    if lazy:
        # per-utterance memory; the decoder folds beam lanes into the
        # cross-attention query axis
        mem_mask = (torch.arange(s_max, device=dev)[None, :]
                    < xlens[:, None])[:, None, :]
        cache = decoder_init(feats, kv_len, k)
    else:
        mem_mask = (torch.arange(s_max, device=dev)[None, :]
                    < xlens.repeat_interleave(k)[:, None])[:, None, :]
        cache = decoder_init(feats.repeat_interleave(k, dim=0), kv_len)

    yseq = torch.full((b, k, buf_len), cfg.eos, dtype=torch.int64, device=dev)
    yseq[..., 0] = cfg.sos
    score = torch.full((b, k), NEG, device=dev)
    score[:, 0] = 0.0
    alive = torch.zeros((b, k), dtype=torch.bool, device=dev)
    alive[:, 0] = True
    # anc[s, b, k]: the stored lane whose row s belongs to hypothesis (b, k);
    # one row the kernel gathers and nothing reads on the eager path
    anc = torch.arange(k, device=dev).expand(kv_len if lazy else 1, b,
                                             k).clone()
    logp_rows = cum_b = ctc_state = None
    if cfg.ctc_weight > 0:
        # pad the CTC time axis to a multiple of 128, then apply the
        # reference padding, as the JAX package does: the extra frames are
        # ordinary padded frames (blank 0, LOG_ZERO elsewhere)
        t_pad = -(-s_max // 128) * 128
        log_probs = ctc_prefix.pad_log_probs(
            F.pad(ctc_log_probs.float(), (0, 0, 0, t_pad - s_max)), xlens,
            cfg.blank)
        # loop-invariant scorer inputs: the transposed table whose rows the
        # step gathers (one row per candidate token; at b = 1 the reshape
        # is a strided view, and the gather takes rows), and the blank
        # cumsum
        logp_rows = log_probs.transpose(1, 2).reshape(b * v, t_pad).contiguous()
        cum_b = torch.cumsum(log_probs[:, :, cfg.blank], dim=1)
        ctc_state = ctc_prefix.init_state(log_probs, k, cfg.sos, cfg.blank)
    state = BeamState(
        i=torch.zeros((1,), dtype=torch.int32, device=dev),
        yseq=yseq, score=score, alive=alive, anc=anc,
        ended_best=torch.full((b, buf_len), NEG, device=dev),
        ended_cnt=torch.zeros((b, buf_len), dtype=torch.int64, device=dev),
        best_score=torch.full((b,), NEG, device=dev),
        best_yseq=torch.full((b, buf_len), cfg.eos, dtype=torch.int64,
                             device=dev),
        best_len=torch.zeros((b,), dtype=torch.int64, device=dev),
        stop=torch.zeros((b,), dtype=torch.bool, device=dev),
        ctc=ctc_state, cache=cache)
    return state, LoopInputs(xlens, mem_mask, logp_rows, cum_b)


def _column(i, b: int, k: Optional[int] = None):
    """Column ``i`` (a (1,) int64 tensor) of every row of a (B, L) or
    (B, K, L) tensor, as a gather / scatter index."""
    return (i.view(1, 1).expand(b, 1) if k is None
            else i.view(1, 1, 1).expand(b, k, 1))


def beam_step(cfg: BeamSearchConfig, decoder_step: Callable, st: BeamState,
              inp: LoopInputs) -> BeamState:
    """One step of the search (the JAX package's ``body``): every use of
    the step index stays on the device and no tensor is read on the
    host."""
    b, k, buf_len = st.yseq.shape
    n = b * k
    v = cfg.vocab
    eos = cfg.eos
    w_ctc = cfg.ctc_weight
    w_dec = 1.0 - w_ctc
    use_ctc = w_ctc > 0
    lazy = cfg.lazy_reorder
    dev = st.yseq.device
    if dev.type == "cpu":
        warm_exp()  # before the step's first exp (ROADMAP C21)
    xlens = inp.xlens
    i = st.i.long()  # (1,)
    lane_active = ~st.stop & (i < xlens)  # (B,)
    ar_k = torch.arange(k, device=dev)
    y_t = st.yseq.index_select(2, i).reshape(n)
    ctc_state = st.ctc

    # 1. attention-decoder scores; this step's row is each lane's own
    cache = st.cache
    if lazy:
        kv_len = st.anc.shape[0]
        anc = st.anc.index_copy(0, i.clamp_max(kv_len - 1),
                                ar_k.expand(1, b, k))
        onehot = anc[..., None] == ar_k  # (S, B, K, J)
        s_valid = torch.arange(kv_len, device=dev) <= i
        lane_bias = torch.where(s_valid[:, None, None, None] & onehot, 0.0,
                                NEG).permute(1, 2, 3, 0)  # (B, K, J, S)
        dec_logp, cache = decoder_step(y_t, st.i, cache, inp.mem_mask,
                                       lane_bias)
    else:
        anc = st.anc
        dec_logp, cache = decoder_step(y_t, st.i, cache, inp.mem_mask)
    dec_logp = dec_logp.view(b, k, v)

    # 2. pre-beam on decoder scores, then CTC prefix scores of the
    # candidates (+ eos, which CTC always scores); with CTC the same
    # launch gathers the candidates' rows of the table
    n_pre = cfg.pre_beam_size
    n_cand = n_pre + 1  # + explicit eos slot
    if use_ctc:
        t_pad = inp.logp_rows.shape[1]
        dec_top, part_ids, xs_rows = topk_gather_rows(dec_logp, n_pre,
                                                      inp.logp_rows)
        xs = xs_rows.view(b, k, n_pre, t_pad).permute(3, 0, 1, 2)
        psi_cand, psi_eos, r_cands = (
            ctc_prefix.score_candidates_cols_batched(
                xs, inp.cum_b, xlens, ctc_state, part_ids, eos, cfg.blank))
    else:
        dec_top, part_ids = topk_lastdim(dec_logp, n_pre)  # (B, K, S')

    if cfg.fused_bookkeeping:
        # 3-6 in one kernel launch
        upd = beam_update(
            st.i, xlens, dec_top, dec_logp[..., eos].contiguous(),
            psi_cand if use_ctc else None,
            psi_eos if use_ctc else None,
            ctc_state.s if use_ctc else None,
            part_ids, st.score, st.alive, st.stop, st.yseq, anc,
            st.ended_best, st.ended_cnt, st.best_score, st.best_yseq,
            st.best_len, w_dec=w_dec, w_ctc=w_ctc, eos=eos, neg=NEG,
            d_end=D_END, m_end=M_END)
        if use_ctc:
            ctc_state = ctc_prefix.select_candidates(
                ctc_state, upd["psi_sel"], r_cands, upd["prev"],
                upd["slot"], upd["token"])
        if not lazy:
            cache = reorder_cache(cache, upd["prev"])
        return BeamState(
            st.i + 1, upd["yseq"], upd["score"], upd["alive"],
            upd["anc"] if lazy else anc, upd["ended_best"],
            upd["ended_cnt"], upd["best_score"], upd["best_yseq"],
            upd["best_len"], upd["stop"], ctc_state, cache)

    cand_tokens = torch.cat(
        [part_ids, torch.full((b, k, 1), eos, dtype=torch.int64, device=dev)],
        dim=-1)
    cand_dec = torch.cat([dec_top, dec_logp[..., eos:eos + 1]], dim=-1)
    weighted = w_dec * cand_dec  # (B, K, S'+1)
    if use_ctc:
        psi_all = torch.cat([psi_cand, psi_eos[..., None]], dim=-1)
        gain = psi_all - ctc_state.s[..., None]
        weighted = weighted + w_ctc * gain
    # dedup: if eos is among the pre-beam ids, mask the explicit slot
    eos_dup = (part_ids == eos).any(dim=-1)
    weighted[..., -1] = torch.where(eos_dup, NEG, weighted[..., -1])
    weighted = weighted + st.score[..., None]
    weighted = torch.where(st.alive[..., None], weighted, NEG)

    # 3. per-utterance flat top-k over (K, S'+1) candidates
    top_scores, top_idx = topk_lastdim(weighted.view(b, k * n_cand), k)
    prev = top_idx // n_cand  # (B, K)
    token = torch.gather(cand_tokens.view(b, k * n_cand), 1, top_idx)

    # 4. successors: hypotheses, ancestry (the caches stay put) or the
    # self caches, and the CTC state
    new_yseq = torch.gather(st.yseq, 1,
                            prev[..., None].expand(b, k, buf_len))
    new_yseq.scatter_(2, _column(i + 1, b, k), token[..., None])
    if lazy:
        anc = torch.gather(anc, 2, prev[None].expand(anc.shape[0], b, k))
    else:
        cache = reorder_cache(cache, prev)
    if use_ctc:
        psi_sel = torch.gather(psi_all.view(b, k * n_cand), 1, top_idx)
        ctc_state = ctc_prefix.select_candidates(
            ctc_state, psi_sel, r_cands, prev, top_idx % n_cand, token)

    # 5. retire ended hypotheses (natural eos, or forced at the last step)
    forced = i >= xlens - 1  # (B,)
    ended = ((token == eos) | forced[:, None]) & lane_active[:, None]
    # the final step appends eos to every hyp, even after a natural eos
    col2 = _column(i + 2, b, k)
    new_yseq.scatter_(2, col2, torch.where(forced[:, None, None], eos,
                                           new_yseq.gather(2, col2)))
    hyp_len = torch.where(forced, i + 3, i + 2)

    ended_scores = torch.where(ended, top_scores, NEG)
    step_best = ended_scores.amax(dim=1)
    best_slot = torch.argmax(ended_scores, dim=1)  # first maximal
    col = _column(i, b)
    ended_best = st.ended_best.scatter(1, col, torch.maximum(
        st.ended_best.gather(1, col), step_best[:, None]))
    ended_cnt = st.ended_cnt.scatter(1, col, st.ended_cnt.gather(1, col)
                                     + ended.sum(dim=1, keepdim=True))
    better = (step_best > st.best_score) & lane_active
    best_score = torch.where(better, step_best, st.best_score)
    picked = new_yseq[torch.arange(b, device=dev), best_slot]
    best_yseq = torch.where(better[:, None], picked, st.best_yseq)
    best_len = torch.where(better, hyp_len, st.best_len)

    new_alive = ~ended & lane_active[:, None]
    new_score = torch.where(new_alive, top_scores, NEG)
    # freeze the small state of finished utterances
    act = lane_active[:, None]
    yseq = torch.where(act[..., None], new_yseq, st.yseq)
    score = torch.where(act, new_score, st.score)
    alive = torch.where(act, new_alive, st.alive)

    # 6. end detection: M consecutive recent lengths whose best ended
    # score trails the global best by more than |D_END|; a length before
    # step 0 (j < 0) counts as none, as the JAX m_term masks it
    count = torch.zeros((b,), dtype=torch.int64, device=dev)
    for m in range(M_END):
        j = i - m - 2
        jc = _column(j.clamp_min(0), b)
        count += ((j >= 0) & (ended_cnt.gather(1, jc)[:, 0] > 0)
                  & (ended_best.gather(1, jc)[:, 0] - best_score
                     < D_END)).long()
    newly_stopped = (count >= M_END) | ~alive.any(dim=1)
    stop = st.stop | (newly_stopped & lane_active)
    return BeamState(st.i + 1, yseq, score, alive, anc, ended_best,
                     ended_cnt, best_score, best_yseq, best_len, stop,
                     ctc_state, cache)


def all_done(st: BeamState, inp: LoopInputs) -> torch.Tensor:
    """The JAX loop's ``cond``, negated: every utterance stopped or past
    its frames (a bool tensor on the device)."""
    return (st.stop | (st.i.long() >= inp.xlens)).all()


@torch.inference_mode()
def beam_search_batched(
    cfg: BeamSearchConfig,
    decoder_step: Callable,  # (y (N,), pos, cache, mem_mask[, lane_bias])
    #                          -> (logp (N, V), cache); pos a (1,) int32
    #                          tensor on the device
    decoder_init: Callable,  # (memory, maxlen[, beam]) -> cache
    feats: torch.Tensor,  # (B, S, D) encoder outputs (padded)
    ctc_log_probs: Optional[torch.Tensor],  # (B, S, V) CTC log-softmax
    #                                         (padded); None without CTC
    xlens: torch.Tensor,  # (B,) true frame counts
    *,
    device_loop: bool = True,
    stop_every: int = device_loop_mod.STOP_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode a batch. Returns (yseqs (B, L), lengths (B,), scores (B,)).

    yseq[:, 0] == sos; yseq[b, 1:length[b]] are the tokens incl. the final
    eos. ``device_loop`` (the default): the host reads the stop flag once
    every ``stop_every`` steps, and on the card the steps between two reads
    run as one replay of a CUDA graph (``decode/device_loop.py``); on the
    CPU they run one after another in Python. ``device_loop=False`` is the
    host loop, a read after every step and no graph (the comparison
    ``chip_smoke.py`` runs). Every loop stops at the last step that a
    frame count allows. ``beam_search_batched.last_run`` records the run:
    steps, reads, replays, captures and their milliseconds."""
    if cfg.shared_src_kv != cfg.lazy_reorder:
        raise ValueError(
            "shared_src_kv and lazy_reorder must agree: the shared-source "
            "decoders step with a lane_bias and keep no self_k/self_v to "
            "reorder, and the eager S2T decoder takes no lane_bias")
    if stop_every < 1:
        raise ValueError(f"stop_every must be >= 1, got {stop_every}")
    dev = feats.device
    # the frame counts on the host (one read unless they are there already)
    steps_max = max((int(x) for x in xlens.tolist()), default=0)
    xlens = xlens.to(dev)

    def step(st, inp):
        return beam_step(cfg, decoder_step, st, inp)

    if not (device_loop and dev.type == "cuda"):
        st, inp = init_search(cfg, decoder_init, feats, ctc_log_probs, xlens)
        st, stats = device_loop_mod.run(step, all_done, st, inp, steps_max,
                                        stop_every if device_loop else 1)
        beam_search_batched.last_run = stats
        return st.best_yseq, st.best_len, st.best_score
    with device_loop_mod.on_loop_stream(dev) as caller:
        st, inp = init_search(cfg, decoder_init, feats, ctc_log_probs, xlens)
        st, stats = device_loop_mod.run(step, all_done, st, inp, steps_max,
                                        stop_every, (cfg, decoder_step))
        # a graph's buffers serve the next batch of the shape: copies out
        out = tuple(x.clone() for x in (st.best_yseq, st.best_len,
                                          st.best_score))
    for x in out:
        x.record_stream(caller)
    beam_search_batched.last_run = stats
    return out


beam_search_batched.last_run = {}


def greedy_ctc(log_probs: torch.Tensor, xlens: torch.Tensor, blank: int = 0):
    """Batched greedy CTC: argmax, collapse repeats, drop blanks.

    log_probs (B, T, V), xlens (B,). Returns (tokens (B, T) right-padded
    with ``blank``, lengths (B,))."""
    b, t, _ = log_probs.shape
    ids = log_probs.argmax(dim=-1)
    valid = torch.arange(t, device=ids.device)[None, :] < xlens.to(ids.device)[:, None]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev) & valid
    pos = torch.where(keep, keep.cumsum(dim=1) - 1, t)
    out = torch.full((b, t + 1), blank, dtype=ids.dtype, device=ids.device)
    out.scatter_(1, pos, ids)  # dropped tokens land in the spare column
    return out[:, :t], keep.sum(dim=1)
