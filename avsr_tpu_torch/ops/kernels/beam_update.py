"""One beam step's bookkeeping after scoring, as one kernel.

Counterpart of ``avsr_tpu/ops/pallas/beam_update.py`` ``beam_update``:
everything in a beam step after the CTC candidate scoring and before the
CTC state update. That is the candidate weighting, the flat top-k over the
(K, S'+1) candidates of each utterance, the successor gathers (token
buffer and lazy-reorder ancestry), eos retirement, running-best tracking
and end detection (the reference's e2e_asr_common.end_detect). Unfused,
that is about a hundred tiny launches a step (``decode/beam.py``).

``beam_update`` dispatches on the tensor's device: on the CPU it runs
``beam_update_plain``, on a CUDA device it launches ``csrc/beam_update.cu``:
a warp's kernel up to ``MAX_K`` hypotheses and ``MAX_CAND`` candidates
K*(S'+1), a block's beyond (``wide_launches`` counts those launches; a
beam of 10 has 160 candidates): each warp sorts a chunk of 128
candidates into a list, the lists merged by their entries' places, with
no round of block barriers; a launch whose lists and item tile do not fit
a block's shared memory raises.
Both are bit-identical to the unfused step of ``decode/beam.py``: the same
fp32 operations in the same order, each rounded on its own (no fused
multiply-add), and selections that copy values. The kernel always gathers
the lazy-reorder ancestry it is given: the beam's eager path
(``lazy_reorder=False``) hands it a one-row ancestry, ignores the one it
writes and reorders its self caches by the returned ``prev``, so the JAX
kernel's ``lazy`` switch is not needed here. The port has no length
penalty (0 in every shipped configuration).

Tokens, indices and counts are int64 and masks bool, the port's types.
The step ``i`` is read on the device, as the TPU kernel reads it from
SMEM, so a launch captured in a CUDA graph reads each replay's step.
"""

from __future__ import annotations

import ctypes

import torch

from avsr_tpu_torch.ops.kernels import _build

_BIG = 2**62
MAX_K = 16  # csrc/beam_update.cu kMaxK
MAX_CAND = 128  # csrc/beam_update.cu kMaxCand

_OUT = ("token", "prev", "slot", "psi_sel", "score", "alive", "yseq", "anc",
        "ended_best", "ended_cnt", "best_score", "best_yseq", "best_len",
        "stop")


def beam_update_plain(i, xlens, dec_top, dec_eos, psi_cand, psi_eos,
                      ctc_s, part_ids, score, alive, stop, yseq, anc,
                      ended_best, ended_cnt, best_score, best_yseq, best_len,
                      *, w_dec: float, w_ctc: float, eos: int, neg: float,
                      d_end: float, m_end: int):
    """The TPU kernel's body in its own formulation: iterated (max, lowest
    flat index, mask) top-k, one-hot sum-selects for the token and psi,
    beam-axis gathers, retirement, best tracking and end detection. With
    ``psi_cand`` None the CTC term is left out. ``i``: the step, an int or
    a one-element tensor on the inputs' device, never read on the host."""
    b, k, sp = part_ids.shape
    c = sp + 1  # pre-beam tokens + the explicit eos slot
    ll = yseq.shape[2]
    dev = part_ids.device
    i = _build.device_step(i, dev).long()  # (1,)
    lane_active = ~stop & (i < xlens)  # (B,)
    forced = i >= xlens - 1  # (B,)

    # candidate scores, in the unfused step's order of operations
    cand_dec = torch.cat([dec_top, dec_eos[:, :, None]], dim=-1)  # (B, K, C)
    cand_tok = torch.cat([part_ids, torch.full_like(part_ids[..., :1], eos)],
                         dim=-1)
    weighted = w_dec * cand_dec
    if psi_cand is not None:
        psi_all = torch.cat([psi_cand, psi_eos[:, :, None]], dim=-1)
        weighted = weighted + w_ctc * (psi_all - ctc_s[:, :, None])
    else:
        psi_all = torch.zeros_like(cand_dec)
    c_iota = torch.arange(c, device=dev)
    eos_dup = (part_ids == eos).any(dim=-1, keepdim=True)  # (B, K, 1)
    weighted = torch.where((c_iota == c - 1) & eos_dup, neg, weighted)
    weighted = weighted + score[:, :, None]
    weighted = torch.where(alive[:, :, None], weighted, neg)

    # flat top-k over (K, C): k rounds of max / lowest index / mask
    x = weighted.reshape(b, k * c)
    flat_tok = cand_tok.reshape(b, k * c)
    flat_psi = psi_all.reshape(b, k * c)
    iota = torch.arange(k * c, device=dev)
    tops, idxs, toks, psis = [], [], [], []
    for _ in range(k):
        m = x.amax(dim=1, keepdim=True)
        sel = torch.where(x == m, iota, _BIG).amin(dim=1, keepdim=True)
        one = iota == sel
        tops.append(m[:, 0])
        idxs.append(sel[:, 0])
        toks.append(torch.where(one, flat_tok, 0).sum(dim=1))
        psis.append(torch.where(one, flat_psi, 0.0).sum(dim=1))
        x = torch.where(one, float("-inf"), x)
    top_scores = torch.stack(tops, 1)  # (B, K)
    top_idx = torch.stack(idxs, 1)
    token = torch.stack(toks, 1)
    psi_sel = torch.stack(psis, 1)
    prev = top_idx // c
    slot = top_idx - prev * c

    # successor token buffers: rows by prev, then the new token at i+1 and
    # the forced final eos at i+2
    y_new = torch.gather(yseq, 1, prev[:, :, None].expand(b, k, ll))
    l_iota = torch.arange(ll, device=dev)
    y_new = torch.where(l_iota == i + 1, token[:, :, None], y_new)
    y_new = torch.where((l_iota == i + 2) & forced[:, None, None], eos, y_new)
    yseq_out = torch.where(lane_active[:, None, None], y_new, yseq)
    # lazy-reorder ancestry: anc[s, b, k] <- anc[s, b, prev[b, k]]
    anc_out = torch.gather(anc, 2, prev[None].expand(anc.shape[0], b, k))

    # retirement and the per-step ended statistics
    ended = ((token == eos) | forced[:, None]) & lane_active[:, None]
    hyp_len = torch.where(forced, i + 3, i + 2)  # incl. sos and eos
    ended_scores = torch.where(ended, top_scores, neg)
    step_best = ended_scores.amax(dim=1)  # (B,)
    col = torch.arange(ll, device=dev)
    ended_best_out = torch.maximum(
        ended_best, torch.where(col == i, step_best[:, None], float("-inf")))
    ended_cnt_out = ended_cnt + torch.where(col == i, ended.sum(dim=1)[:, None],
                                            0)

    # running best (ties toward the lower slot)
    k_iota = torch.arange(k, device=dev)
    best_slot = torch.where(ended_scores == step_best[:, None], k_iota,
                            _BIG).amin(dim=1)
    better = (step_best > best_score) & lane_active
    best_score_out = torch.where(better, step_best, best_score)
    picked = y_new[torch.arange(b, device=dev), best_slot]  # (B, L)
    best_yseq_out = torch.where(better[:, None], picked, best_yseq)
    best_len_out = torch.where(better, hyp_len, best_len)

    # freeze the small state of finished lanes
    alive_new = ~ended & lane_active[:, None]
    score_out = torch.where(lane_active[:, None],
                            torch.where(alive_new, top_scores, neg), score)
    alive_out = torch.where(lane_active[:, None], alive_new, alive)

    # end detection: M consecutive recent lengths whose best ended score
    # trails the running best by more than |d_end|
    count = torch.zeros_like(best_len)
    for mm in range(m_end):
        j = i - mm - 2
        jc = j.clamp_min(0).expand(b)[:, None]
        ok = (j >= 0) & (ended_cnt_out.gather(1, jc)[:, 0] > 0)
        worse = (ended_best_out.gather(1, jc)[:, 0] - best_score_out) < d_end
        count = count + (ok & worse).long()
    newly = (count >= m_end) | ~alive_out.any(dim=1)
    stop_out = stop | (newly & lane_active)
    return dict(zip(_OUT, (
        token, prev, slot, psi_sel, score_out, alive_out, yseq_out, anc_out,
        ended_best_out, ended_cnt_out, best_score_out, best_yseq_out,
        best_len_out, stop_out)))


def _launch(i, ins, use_ctc, w_dec, w_ctc, eos, neg, d_end, m_end):
    (xlens, dec_top, dec_eos, psi_cand, psi_eos, ctc_s, part_ids, score,
     alive, stop, yseq, anc, ended_best, ended_cnt, best_score, best_yseq,
     best_len) = ins
    b, k, sp = part_ids.shape
    ll = yseq.shape[2]
    dev = part_ids.device
    step = _build.device_step(i, dev)
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    outs = dict(
        token=torch.empty((b, k), dtype=torch.int64, device=dev),
        prev=torch.empty((b, k), dtype=torch.int64, device=dev),
        slot=torch.empty((b, k), dtype=torch.int64, device=dev),
        psi_sel=torch.empty((b, k), device=dev),
        score=torch.empty_like(score),
        alive=torch.empty_like(alive),
        yseq=torch.empty_like(yseq),
        anc=torch.empty_like(anc),
        ended_best=torch.empty_like(ended_best),
        ended_cnt=torch.empty_like(ended_cnt),
        best_score=torch.empty_like(best_score),
        best_yseq=torch.empty_like(best_yseq),
        best_len=torch.empty_like(best_len),
        stop=torch.empty_like(stop),
    )
    ptrs = [0 if x is None else x.data_ptr() for x in ins]
    ptrs += [outs[name].data_ptr() for name in _OUT]
    fn = _build.function(
        "avsr_beam_update",
        (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 8 + (ctypes.c_float,) * 4
        + (ctypes.c_void_p,),
    )
    err = fn((ctypes.c_void_p * len(ptrs))(*ptrs), step.data_ptr(), b, k, sp,
             ll,
             anc.shape[0], eos, m_end, int(use_ctc), w_dec, w_ctc, neg,
             d_end, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("beam_update", err)
    beam_update.launches += 1
    beam_update.wide_launches += k > MAX_K or k * (sp + 1) > MAX_CAND
    return outs


def beam_update(i, xlens, dec_top, dec_eos, psi_cand, psi_eos, ctc_s,
                part_ids, score, alive, stop, yseq, anc, ended_best,
                ended_cnt, best_score, best_yseq, best_len, *, w_dec: float,
                w_ctc: float, eos: int, neg: float, d_end: float, m_end: int):
    """One fused bookkeeping update of beam step ``i``: a one-element int32
    or int64 tensor on the inputs' device, which the kernel reads there
    (the beam's device loop), or an int (made into one).

    Shapes: xlens (B,), dec_top (B, K, S'), dec_eos (B, K), psi_cand
    (B, K, S') / psi_eos (B, K) / ctc_s (B, K) or all three None (no CTC
    term), part_ids (B, K, S'), score (B, K), alive (B, K), stop (B,), yseq
    (B, K, L), anc (S, B, K), ended_best and ended_cnt (B, L), best_score
    (B,), best_yseq (B, L), best_len (B,). Floats are fp32, ids and counts
    int64, masks bool. Returns a dict of the post-step values: token,
    prev, slot, psi_sel, score, alive, yseq, anc, ended_best, ended_cnt,
    best_score, best_yseq, best_len, stop."""
    use_ctc = psi_cand is not None
    if use_ctc != (psi_eos is not None) or use_ctc != (ctc_s is not None):
        raise ValueError("psi_cand, psi_eos and ctc_s go together")
    b, k, sp = part_ids.shape
    ll = yseq.shape[2]
    spec = dict(
        xlens=((b,), torch.int64), dec_top=((b, k, sp), torch.float32),
        dec_eos=((b, k), torch.float32),
        psi_cand=((b, k, sp), torch.float32), psi_eos=((b, k), torch.float32),
        ctc_s=((b, k), torch.float32), part_ids=((b, k, sp), torch.int64),
        score=((b, k), torch.float32), alive=((b, k), torch.bool),
        stop=((b,), torch.bool), yseq=((b, k, ll), torch.int64),
        anc=((anc.shape[0], b, k), torch.int64),
        ended_best=((b, ll), torch.float32), ended_cnt=((b, ll), torch.int64),
        best_score=((b,), torch.float32), best_yseq=((b, ll), torch.int64),
        best_len=((b,), torch.int64),
    )
    ins = (xlens, dec_top, dec_eos, psi_cand, psi_eos, ctc_s, part_ids, score,
           alive, stop, yseq, anc, ended_best, ended_cnt, best_score,
           best_yseq, best_len)
    for (name, (shape, dtype)), x in zip(spec.items(), ins):
        if x is None:
            continue
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"beam_update: {name} is {tuple(x.shape)} "
                             f"{x.dtype}, expected {shape} {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"beam_update: {name} must be contiguous")
        if x.device != part_ids.device:
            raise ValueError(f"beam_update: {name} on {x.device}, part_ids "
                             f"on {part_ids.device}")
    kw = dict(w_dec=w_dec, w_ctc=w_ctc, eos=eos, neg=neg, d_end=d_end,
              m_end=m_end)
    if part_ids.device.type == "cpu":
        return beam_update_plain(i, *ins, **kw)
    if part_ids.device.type != "cuda":
        raise ValueError(f"no beam_update for device {part_ids.device}")
    return _launch(i, ins, use_ctc, **kw)


beam_update.launches = 0
beam_update.wide_launches = 0
