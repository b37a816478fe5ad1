"""CTC prefix scoring (hybrid CTC/attention) as closed-form parallel ops.

Counterpart of ``avsr_tpu/decode/ctc_prefix.py``, the part the batched beam
uses. The reference scorer (CTCPrefixScoreTH) loops over T frames in every
decode step; its forward recursions

    r_n[t] = logaddexp(r_n[t-1], phi[t-1]) + x[t]
    r_b[t] = logaddexp(r_n[t-1], r_b[t-1]) + b[t]

are first-order linear recurrences in the log semiring, so they have closed
forms through prefix sums:

    r_n[t] = cumX[t] + logcumsumexp_{j<=t}( phi[j-1] - cumX[j-1] )
    r_b[t] = cumB[t] + logcumsumexp_{j<=t}( r_n[j-1] - cumB[j-1] )
    psi    = logsumexp_t( phi[t-1] + x[t] )  (+ the init term)

Each step is then a few (T, N) tensor ops and two ``cumlogsumexp`` scans
(``ops/kernels/scan_logsumexp``) over N = B*K*S' candidate columns in the
T-major layout of the JAX package. Everything is fp32 and no product runs
in TF32. The utterance length enters through pre-padded log-probs (frames
>= xlen carry log-prob 0 for blank, LOG_ZERO elsewhere), like the
reference's padding.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from avsr_tpu_torch.ops.kernels.scan_logsumexp import cumlogsumexp

# the reference's logzero constant
LOG_ZERO = -1.0e10
NEG_INF = float("-inf")


class CTCPrefixState(NamedTuple):
    r: torch.Tensor  # (B, K, T, 2) forward probs [n, b] of each hyp's prefix
    s: torch.Tensor  # (B, K) absolute prefix score log(psi) of each hyp
    last: torch.Tensor  # (B, K) last token id of each prefix
    out_len: torch.Tensor  # (B,) generated tokens so far (excl. sos)


def pad_log_probs(log_probs: torch.Tensor, xlens: torch.Tensor,
                  blank: int = 0) -> torch.Tensor:
    """(B, T, V): frames beyond xlen set to [blank: 0, others: LOG_ZERO]."""
    t = log_probs.shape[1]
    pad = torch.arange(t, device=log_probs.device)[None, :] >= xlens[:, None]
    x = torch.where(pad[..., None], LOG_ZERO, log_probs)
    x[..., blank] = torch.where(pad, 0.0, log_probs[..., blank])
    return x


def init_state(log_probs: torch.Tensor, beam: int, sos: int,
               blank: int = 0) -> CTCPrefixState:
    """Initial state for ``beam`` identical <sos> hypotheses of each of the
    B utterances; ``log_probs`` (B, T, V) already padded."""
    b, t = log_probs.shape[:2]
    dev = log_probs.device
    r = torch.full((b, beam, t, 2), LOG_ZERO, device=dev)
    r[..., 1] = torch.cumsum(log_probs[:, :, blank], dim=1)[:, None, :]
    return CTCPrefixState(
        r=r,
        s=torch.zeros((b, beam), device=dev),
        last=torch.full((b, beam), sos, dtype=torch.int64, device=dev),
        out_len=torch.zeros((b,), dtype=torch.int64, device=dev),
    )


def _shift_down(x: torch.Tensor, fill: float) -> torch.Tensor:
    """x[t-1] at row t, ``fill`` at row 0."""
    return torch.cat([torch.full_like(x[:1], fill), x[:-1]])


def score_candidates_cols_batched(
    xs: torch.Tensor,  # (T, B, K, S) candidate log-probs, T-major
    cum_b: torch.Tensor,  # (B, T) inclusive cumsum of blank log-probs
    xlens: torch.Tensor,  # (B,)
    state: CTCPrefixState,
    part_ids: torch.Tensor,  # (B, K, S)
    eos: int,
    blank: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score the pre-beam candidate extensions of every prefix.

    Tokens outside ``part_ids`` would score about LOG_ZERO and can never
    win the beam, so only the (B, K, S) candidate columns and eos (always
    scored) are computed. Every tensor is 2-D (T, N = B*K*S), b-major in N.

    Returns psi_cand (B, K, S) absolute prefix scores at ``part_ids`` (eos
    and blank overrides applied), psi_eos (B, K) the prefix-terminal score
    of eos, and r_cands (B, K, S, T, 2) the forward probs of each candidate
    extension.
    """
    t_max, b, k, s = xs.shape
    n = b * k * s
    nbk = b * k
    dev = xs.device
    xs2 = xs.reshape(t_max, n)

    r_prev = state.r.reshape(nbk, t_max, 2).permute(1, 2, 0)  # (T, 2, BK)
    r_bb = r_prev[:, 1]  # blank-terminated paths
    r_sum = torch.logaddexp(r_prev[:, 0], r_bb)  # (T, BK)

    def exp_s(x_tbk):  # (T, BK) -> (T, N): repeat along the S slots
        return x_tbk[:, :, None].expand(t_max, nbk, s).reshape(t_max, n)

    is_last = (part_ids == state.last[:, :, None]).reshape(1, n)
    phi = torch.where(is_last, exp_s(r_bb), exp_s(r_sum))  # (T, N)

    start_n = state.out_len.clamp_min(1).repeat_interleave(k * s)  # (N,)
    out0_n = (state.out_len == 0).repeat_interleave(k * s)
    xlen_n = xlens.repeat_interleave(k * s)
    tidx = torch.arange(t_max, device=dev)[:, None]  # (T, 1)

    # inclusive cumsum in fp32 with torch.cumsum (the JAX package uses a
    # tril matmul at HIGHEST precision); the two differ only in summation
    # order
    cum_x = torch.cumsum(xs2, dim=0)
    cum_x_m1 = _shift_down(cum_x, 0.0)
    phi_m1 = _shift_down(phi, LOG_ZERO)

    # u[j] = phi[j-1] - cumX[j-1] for j >= start; the init contribution
    # (r_n[0] = x[0] when out_len == 0) lands at j = start-1 as exactly 0
    # because cumX[0] == x[0]. Rows at padded frames (j >= xlen) are masked
    # out: their -cumX term is huge (+1e10 per padded frame).
    ge_start = tidx >= start_n[None, :]  # (T, N)
    init_here = (tidx == start_n[None, :] - 1) & out0_n[None, :]
    u = torch.where(ge_start, phi_m1 - cum_x_m1,
                    torch.where(init_here, 0.0, NEG_INF))
    u = torch.where(tidx < xlen_n[None, :], u, NEG_INF)
    r_n = (cum_x + cumlogsumexp(u)).clamp_min(LOG_ZERO)

    # r_b[t] = cumB[t] + LSE_{j<=t} (r_n[j-1] - cumB[j-1]), j >= start
    cum_b_n = cum_b.t()[:, :, None].expand(t_max, b, k * s).reshape(t_max, n)
    cum_b_m1 = _shift_down(cum_b_n, 0.0)
    r_n_m1 = _shift_down(r_n, LOG_ZERO)
    vterm = torch.where(ge_start & (tidx < xlen_n[None, :] + 1),
                        r_n_m1 - cum_b_m1, NEG_INF)
    r_b = (cum_b_n + cumlogsumexp(vterm)).clamp_min(LOG_ZERO)

    # log psi = LSE(r_n[start-1], LSE_{t in [start, T)} phi[t-1] + x[t])
    psi_terms = torch.where(ge_start, phi_m1 + xs2, NEG_INF)
    init_term = torch.where(out0_n, xs2[0], LOG_ZERO)  # (N,)
    log_psi_c = torch.logaddexp(torch.logsumexp(psi_terms, dim=0),
                                init_term).view(b, k, s)

    # eos scores the prefix-terminal probability r_sum[xlen-1] of each (b, k)
    ar_b = torch.arange(b, device=dev)
    psi_eos = r_sum.view(t_max, b, k)[xlens - 1, ar_b]  # (B, K)

    psi_cand = torch.where(part_ids == eos, psi_eos[:, :, None], log_psi_c)
    psi_cand = torch.where(part_ids == blank, LOG_ZERO, psi_cand)

    r_cands = torch.stack([r_n, r_b], dim=-1).view(t_max, b, k, s, 2)
    return psi_cand, psi_eos, r_cands.permute(1, 2, 3, 0, 4)


def select_candidates(
    state: CTCPrefixState,
    psi_sel: torch.Tensor,  # (B, K') absolute scores of the selections
    r_cands: torch.Tensor,  # (B, K, S, T, 2)
    prev: torch.Tensor,  # (B, K') selected source-hyp indices
    slot: torch.Tensor,  # (B, K') candidate slot (S for the eos slot)
    token: torch.Tensor,  # (B, K') selected token ids
) -> CTCPrefixState:
    """The new state of the selected (prev, slot) candidates. The eos slot
    is clamped to S-1: its state is never read again (the hypothesis
    ends)."""
    b, _, s_max = r_cands.shape[:3]
    ar_b = torch.arange(b, device=r_cands.device)[:, None]
    r_new = r_cands[ar_b, prev, slot.clamp_max(s_max - 1)]  # (B, K', T, 2)
    return CTCPrefixState(r=r_new, s=psi_sel, last=token,
                          out_len=state.out_len + 1)
