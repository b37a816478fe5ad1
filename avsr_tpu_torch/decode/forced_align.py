"""CTC Viterbi forced alignment, batched over utterances.

Counterpart of ``avsr_tpu/decode/forced_align.py``: the Viterbi forward is
one loop over frames with vectorised state transitions over the
blank-interleaved states (2L+1) of every utterance, then a backtrack over
the stored choices, in torch ops on the caller's device. Returns the
per-frame label sequence and the path's score.

The original reference's DP indexes ``logdelta[t-1, s-1]`` at s=0, which
numpy wraps to the last state; this one masks those transitions, as the
JAX package's does (ROADMAP C7), and is held against it.
"""

from __future__ import annotations

from typing import Tuple

import torch

LOG_ZERO = -1.0e11


def interpolate_blank(labels: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """(B, L) -> (B, 2L+1) blank-interleaved state labels."""
    b, l = labels.shape
    out = torch.full((b, 2 * l + 1), blank_id, dtype=labels.dtype,
                     device=labels.device)
    out[:, 1::2] = labels
    return out


def forced_align(
    log_probs: torch.Tensor,  # (B, T, V) CTC log-softmax
    in_lens: torch.Tensor,  # (B,) frame counts
    labels: torch.Tensor,  # (B, L) padded with any id beyond label_lens
    label_lens: torch.Tensor,  # (B,)
    blank_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi alignment. Returns (alignments (B, T) label ids, scores (B,)).

    Frames beyond in_lens carry blanks; states beyond 2*label_lens+1 are
    masked out of the recursion.
    """
    b, t_max, _ = log_probs.shape
    dev = log_probs.device
    s = 2 * labels.shape[1] + 1
    in_lens = in_lens.to(dev)
    label_lens = label_lens.to(dev)
    y_int = interpolate_blank(labels.to(dev), blank_id)  # (B, S)
    n_states = 2 * label_lens + 1  # (B,)
    s_iota = torch.arange(s, device=dev)
    state_valid = s_iota[None, :] < n_states[:, None]

    # emission log-probs per state per frame: (B, T, S)
    emit = torch.gather(log_probs, 2, y_int[:, None, :].expand(b, t_max, s))

    # the skip (s-2) transition: a label differing from the one two back
    prev2 = torch.cat([torch.full((b, 2), blank_id, dtype=y_int.dtype,
                                  device=dev), y_int[:, :-2]], 1)
    can_skip = (y_int != blank_id) & (s_iota[None, :] >= 2) & (y_int != prev2)

    zero = torch.tensor(LOG_ZERO, dtype=log_probs.dtype, device=dev)
    delta = torch.full((b, s), LOG_ZERO, dtype=log_probs.dtype, device=dev)
    delta[:, 0] = emit[:, 0, 0]
    if s > 1:
        delta[:, 1] = torch.where(label_lens > 0, emit[:, 0, 1], zero)
    delta = torch.where(state_valid, delta, zero)

    def shift(x, n):
        return torch.cat([torch.full((b, n), LOG_ZERO, dtype=x.dtype,
                                     device=dev), x[:, :-n]], dim=1)

    choices = []  # (T-1) x (B, S): 0 stay, 1 diag, 2 skip
    for t in range(1, t_max):
        skip = torch.where(can_skip, shift(delta, 2), zero)
        cands = torch.stack([delta, shift(delta, 1), skip])  # (3, B, S)
        best, choice = cands.max(dim=0)  # the first maximal, as argmax
        new_delta = torch.where(state_valid, best + emit[:, t], zero)
        # frames beyond the utterance keep the state (no transition)
        active = (t < in_lens)[:, None]
        delta = torch.where(active, new_delta, delta)
        choices.append(torch.where(active, choice, 0))

    # final state: the better of the last two valid states
    last = n_states - 1
    before = (last - 1).clamp_min(0)
    final_a = torch.gather(delta, 1, last[:, None])[:, 0]
    final_b = torch.gather(delta, 1, before[:, None])[:, 0]
    score = torch.maximum(final_a, final_b)
    state = torch.where(final_a >= final_b, last, before)

    # backtrack over the stored choices, frames T-1 .. 1
    states = [state]
    for t in range(t_max - 1, 0, -1):
        ch = torch.gather(choices[t - 1], 1, state[:, None])[:, 0]
        state = torch.where(t < in_lens, state - ch, state)
        states.append(state)
    states = torch.stack(states[::-1], dim=1)  # (B, T)
    align = torch.gather(y_int, 1, states)
    # pad frames beyond in_lens with blank
    frame_valid = torch.arange(t_max, device=dev)[None, :] < in_lens[:, None]
    align = torch.where(frame_valid, align, blank_id)
    return align, score
