"""The CTC loss's per-sample negative log-likelihood and its gradient.

Counterpart of ``avsr_tpu/ops/ctc.py`` ``ctc_loss``, which runs
``optax.ctc_loss`` (a scan in the compiled step, the lengths device
operands) with zero_infinity semantics and an explicit feasibility rule.
It has no Pallas kernel. Each wrapper dispatches on the tensor's device:
on the CPU it runs its plain PyTorch twin, on a CUDA device it launches
``csrc/ctc_loss.cu`` and counts the launch:

- ``ctc_loss_fwd``: the alpha and beta recursions over the 2L+1 extended
  states, one block each for every sample, side by side; (nll, keep,
  alpha, beta);
- ``ctc_loss_bwd``: the gradient with respect to the logits, one block a
  (frame, sample), every element written by one thread (no atomics).

Both read the lengths, the labels and the upstream gradient on the card:
nothing of the loss goes to the host, so a step that runs it can be
queued ahead of the card (and captured as a CUDA graph). Feasibility
(T >= L + repeats), the zeroing of infeasible or non-finite samples and
the launch sizes come from the padded shapes and those device tensors.

Precision. The posterior of state s at frame t is alpha_t(s) beta_t(s) / P.
In the log domain that is exp(log alpha + log beta - log P), a sum of
numbers of the size of the NLL (thousands of nats at T=384), whose fp32
ulp (2.4e-4 at 3,000) becomes the posterior's relative error: torch's
``F.ctc_loss`` misses float64 by ~3e-4 relative L2 at B=4, T=384, V=64,
L=48. Here both recursions run in float64 and are normalised at every
frame: alpha-hat_t and beta-hat_t are shifted by the largest entry of a
frame (so they stay within [log p, log 3]), the shifts are summed apart
for the loss, and both are kept in float64 for the backward, whose
posterior is exp(a + b - logsumexp_s(a + b)) of O(1) numbers. So the
fp32 gradient's error is about that of the fp32 log-probs it starts from
(~2e-7 relative L2 at that shape), not the NLL's ulp.

The twins (``ctc_fwd_plain``, ``ctc_bwd_plain``) run the same recursion
and the same normalisation in torch ops, in the kernel's term order, in
any float dtype; ``ctc_loss_plain`` is the twin with its hand-written
backward (an autograd function), held against ``gradcheck`` in float64.
"""

from __future__ import annotations

import ctypes

import torch

from avsr_tpu_torch.ops.cpu import warm_exp
from avsr_tpu_torch.ops.kernels import _build

NEG_INF = float("-inf")
# the shift's guard, so that -inf - -inf never occurs (csrc: kGuard)
GUARD = -3.0e38
# the states a block holds (csrc/ctc_loss.cu kThreads * kMaxChunks), so
# L <= (MAX_STATES - 1) // 2
MAX_STATES = 1024


def _lse3(a, b, c):
    """log(e^a + e^b + e^c) in the kernel's order: shifted by the guarded
    largest, the three exps summed left to right."""
    m = torch.maximum(torch.maximum(a, b), c).clamp_min(GUARD)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def _states(labels, label_lengths, blank: int, v: int):
    """The extended label sequence (B, S = 2L+1): blank at even states,
    the labels (clamped into [0, V)) at odd ones; the valid states
    (s < 2 len + 1); whether state s may be entered from s - 2 (a label
    state whose label differs from the one before it)."""
    b, l = labels.shape
    s = 2 * l + 1
    lab = labels.clamp(0, v - 1)
    ext = torch.full((b, s), blank, dtype=torch.int64, device=labels.device)
    ext[:, 1::2] = lab
    pos = torch.arange(s, device=labels.device)
    valid = pos[None, :] < (2 * label_lengths + 1)[:, None]
    skip = torch.zeros((b, s), dtype=torch.bool, device=labels.device)
    skip[:, 3::2] = lab[:, 1:] != lab[:, :-1]
    return ext, valid, skip & valid


def _lengths(logit_lengths, label_lengths, t: int, l: int):
    return logit_lengths.clamp(0, t), label_lengths.clamp(0, l)


def ctc_fwd_plain(logp, labels, logit_lengths, label_lengths,
                  blank: int = 0):
    """The kernel's forward in torch ops: (nll (B,) and keep (B,) in
    logp's dtype, alpha (B, T, S) and beta (B, T, S) in float64), the
    recursions run in float64. alpha[:, t] holds log alpha_t (emission at
    t included) less the largest entry of the frame, beta[:, t] log
    beta_t (emission at t excluded) less the largest entry of
    beta_{t+1} + emission; entries at frames past a sample's length are
    not used. nll is 0 and keep 0 where the sample is infeasible
    (T < L + repeats) or its NLL not finite, else keep is 1."""
    bsz, t, v = logp.shape
    l = labels.shape[1]
    tb, ln = _lengths(logit_lengths, label_lengths, t, l)
    ext, valid, skip = _states(labels, ln, blank, v)
    s = ext.shape[1]
    f64 = dict(dtype=torch.float64, device=logp.device)
    em = logp.gather(2, ext[:, None, :].expand(bsz, t, s)).double()
    ninf = torch.full((bsz, 1), NEG_INF, **f64)
    alpha = torch.full((bsz, t, s), NEG_INF, **f64)
    beta = torch.full((bsz, t, s), NEG_INF, **f64)
    # alpha: frame 0 enters state 0 (blank) or 1 (the first label); each
    # frame is shifted by the last one's largest entry, d, summed apart
    first = torch.arange(s, device=logp.device)[None, :] < 2
    u = torch.where(first & valid, em[:, 0], NEG_INF)
    shift = torch.zeros(bsz, **f64)
    for i in range(t):
        if i:
            d = u.amax(1).clamp_min(GUARD)
            u1 = torch.cat([ninf, u[:, :-1]], 1)
            u2 = torch.where(skip, torch.cat([ninf, ninf, u[:, :-2]], 1)
                             if s > 2 else ninf, NEG_INF)
            new = torch.where(valid, (_lse3(u, u1, u2) - d[:, None])
                              + em[:, i], NEG_INF)
            live = i < tb
            u = torch.where(live[:, None], new, u)
            shift = shift + torch.where(live, d, 0.0)
        alpha[:, i] = u - u.amax(1, keepdim=True).clamp_min(GUARD)
    # log P = the shifts + the last frame's two final states
    fin = u.gather(1, torch.stack([2 * ln, (2 * ln - 1).clamp_min(0)], 1))
    fin = torch.where(torch.stack([ln >= 0, ln > 0], 1), fin, NEG_INF)
    logp_seq = shift + _lse3(fin[:, 0], fin[:, 1],
                             torch.full_like(fin[:, 0], NEG_INF))
    empty = torch.where(ln == 0, 0.0, NEG_INF).double()
    nll = -torch.where(tb > 0, logp_seq, empty)
    # beta: from the last frame, which ends in the last or the
    # second-to-last state
    pos = torch.arange(s, device=logp.device)[None, :]
    last = (pos == 2 * ln[:, None]) | (pos == 2 * ln[:, None] - 1)
    end = torch.where(last, 0.0, NEG_INF).double()
    skip_next = torch.cat([skip[:, 2:], skip.new_zeros(bsz, 2)], 1)[:, :s]
    x = torch.full((bsz, s), NEG_INF, **f64)  # beta_{t+1} + emission
    for i in range(t - 1, -1, -1):
        e = x.amax(1).clamp_min(GUARD)
        x1 = torch.cat([x[:, 1:], ninf], 1)
        x2 = torch.where(skip_next, torch.cat([x[:, 2:], ninf, ninf], 1)
                         if s > 2 else ninf, NEG_INF)
        rec = torch.where(valid, _lse3(x, x1, x2) - e[:, None], NEG_INF)
        vb = torch.where((i == tb - 1)[:, None], end,
                         torch.where((i < tb - 1)[:, None], rec, NEG_INF))
        beta[:, i] = vb
        x = vb + em[:, i]
    lab = labels.clamp(0, v - 1)
    rep = ((lab[:, 1:] == lab[:, :-1])
           & (torch.arange(l - 1, device=labels.device)[None, :]
              < (ln - 1)[:, None])).sum(1) if l > 1 else torch.zeros_like(ln)
    keep = (tb >= ln + rep) & torch.isfinite(nll)
    nll = torch.where(keep, nll, 0.0).to(logp.dtype)
    return nll, keep.to(logp.dtype), alpha, beta


def ctc_bwd_plain(logp, alpha, beta, labels, logit_lengths, label_lengths,
                  keep, grad_nll, blank: int = 0):
    """d (sum_b grad_nll[b] nll[b]) / d logits, (B, T, V) in logp's dtype:
    at a kept sample's frame t < T_b, grad_nll * (softmax - the sum over
    the states of each label of the posterior exp(z - logsumexp_s z)),
    z = alpha + beta (float64), z and its logsumexp in float64; zero at
    every other frame and for a sample that was not kept."""
    bsz, t, v = logp.shape
    l = labels.shape[1]
    tb, ln = _lengths(logit_lengths, label_lengths, t, l)
    ext, valid, _ = _states(labels, ln, blank, v)
    s = ext.shape[1]
    live = torch.arange(t, device=logp.device)[None, :] < tb[:, None]
    z = torch.where(valid[:, None, :] & live[..., None],
                    alpha + beta, NEG_INF)
    norm = z.amax(2, keepdim=True).clamp_min(GUARD)
    norm = norm + torch.log(torch.exp(z - norm).sum(2, keepdim=True))
    gam = torch.where(live[..., None], torch.exp((z - norm).to(logp.dtype)),
                      0.0)
    post = torch.zeros_like(logp).scatter_add_(
        2, ext[:, None, :].expand(bsz, t, s), gam)
    g = (grad_nll * keep)[:, None, None]
    kept = live & (keep > 0)[:, None]
    return torch.where(kept[..., None], g * (torch.exp(logp) - post), 0.0)


def _check(logits, logit_lengths, labels, label_lengths):
    if logits.dim() != 3 or labels.dim() != 2:
        raise ValueError(f"logits (B, T, V) and labels (B, L), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    bsz, _, v = logits.shape
    if labels.shape[0] != bsz or logit_lengths.shape != (bsz,) \
            or label_lengths.shape != (bsz,):
        raise ValueError(f"batch {bsz}: labels {tuple(labels.shape)}, "
                         f"lengths {tuple(logit_lengths.shape)} and "
                         f"{tuple(label_lengths.shape)}")
    if v < 1 or bsz < 1 or logits.shape[1] < 1:
        raise ValueError(f"ctc_loss of an empty batch {tuple(logits.shape)}")
    for x in (logit_lengths, labels, label_lengths):
        if x.device != logits.device:
            raise ValueError(f"logits on {logits.device}, an index on "
                             f"{x.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _card_args(logp, labels, logit_lengths, label_lengths):
    if logp.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {logp.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if logp.dtype != torch.float32 or not logp.is_contiguous():
        raise TypeError("the kernel takes contiguous fp32 log-probs")
    if 2 * labels.shape[1] + 1 > MAX_STATES:
        raise ValueError(f"L = {labels.shape[1]}: the kernel holds at most "
                         f"{(MAX_STATES - 1) // 2} labels")
    return tuple(x.to(torch.int64).contiguous()
                 for x in (labels, logit_lengths, label_lengths))


def ctc_loss_fwd(logp, labels, logit_lengths, label_lengths,
                 blank: int = 0):
    """(nll, keep, alpha, beta) of ``ctc_fwd_plain`` for log-probs (B, T,
    V) fp32, labels (B, L) and lengths (B,) on logp's device. On the card:
    ``ctc_forward_kernel``, grid (2, B): block (0, b) runs sample b's alpha
    recursion, block (1, b) its beta recursion, at the same time. Each
    frame is one step of a chain of T dependent steps (one barrier each),
    and that chain, not the bytes, sets the time."""
    if logp.device.type == "cpu":
        warm_exp()
        return ctc_fwd_plain(logp, labels, logit_lengths, label_lengths,
                             blank)
    if logp.device.type != "cuda":
        raise ValueError(f"no ctc_loss_fwd for device {logp.device}")
    labels, logit_lengths, label_lengths = _card_args(
        logp, labels, logit_lengths, label_lengths)
    bsz, t, v = logp.shape
    l = labels.shape[1]
    fn = _build.function(
        "avsr_ctc_loss_fwd",
        (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,),
    )
    nll = torch.empty(bsz, dtype=torch.float32, device=logp.device)
    keep = torch.empty_like(nll)
    alpha = torch.empty((bsz, t, 2 * l + 1), dtype=torch.float64,
                        device=logp.device)
    beta = torch.empty_like(alpha)
    err = fn(logp.data_ptr(), labels.data_ptr(), logit_lengths.data_ptr(),
             label_lengths.data_ptr(), nll.data_ptr(), keep.data_ptr(),
             alpha.data_ptr(), beta.data_ptr(), bsz, t, v, l, int(blank),
             _stream(logp))
    _build.check("ctc_loss_fwd", err)
    ctc_loss_fwd.launches += 1
    return nll, keep, alpha, beta


ctc_loss_fwd.launches = 0


def ctc_loss_bwd(logp, alpha, beta, labels, logit_lengths, label_lengths,
                 keep, grad_nll, blank: int = 0):
    """The logits' gradient of ``ctc_bwd_plain``, (B, T, V) in logp's
    dtype. On the card: ``ctc_grad_kernel``, one block a (frame, sample):
    the frame's posteriors normalised over the states, each label's sum in
    a fixed order by the first state that carries it, then the row written
    once densely (grad_nll * softmax) and once more at the labels' columns;
    every sum in a fixed order, so two calls are bit-equal. It reads the
    log-probs and writes the gradient, (B, T, V) fp32 each: the bytes bound
    it."""
    if logp.device.type == "cpu":
        warm_exp()
        return ctc_bwd_plain(logp, alpha, beta, labels, logit_lengths,
                             label_lengths, keep, grad_nll, blank)
    if logp.device.type != "cuda":
        raise ValueError(f"no ctc_loss_bwd for device {logp.device}")
    labels, logit_lengths, label_lengths = _card_args(
        logp, labels, logit_lengths, label_lengths)
    bsz, t, v = logp.shape
    l = labels.shape[1]
    for x in (alpha, beta):
        if x.dtype != torch.float64 or x.shape != (bsz, t, 2 * l + 1) \
                or not x.is_contiguous():
            raise ValueError("alpha and beta are the forward's float64 "
                             f"(B, T, 2L+1), got {x.dtype} {tuple(x.shape)}")
    grad_nll = grad_nll.to(torch.float32).contiguous()
    fn = _build.function(
        "avsr_ctc_loss_bwd",
        (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,),
    )
    grad = torch.empty_like(logp)
    err = fn(logp.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
             labels.data_ptr(), logit_lengths.data_ptr(),
             label_lengths.data_ptr(), keep.data_ptr(), grad_nll.data_ptr(),
             grad.data_ptr(), bsz, t, v, l, int(blank), _stream(logp))
    _build.check("ctc_loss_bwd", err)
    ctc_loss_bwd.launches += 1
    return grad


ctc_loss_bwd.launches = 0


class CtcLossFn(torch.autograd.Function):
    """Per-sample CTC NLL (B,) of logits (B, T, V), differentiable in the
    logits: log-softmax in torch, then the forward wrapper; the backward
    wrapper gives the logits' gradient directly (the log-softmax's
    backward folded in). With ``plain`` the twins run on any device and
    dtype (``ctc_loss_plain``)."""

    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths, blank,
                plain):
        logp = torch.log_softmax(logits, dim=-1)
        fwd = ctc_fwd_plain if plain else ctc_loss_fwd
        nll, keep, alpha, beta = fwd(logp, labels, logit_lengths,
                                     label_lengths, blank)
        ctx.save_for_backward(logp, alpha, beta, labels, logit_lengths,
                              label_lengths, keep)
        ctx.blank, ctx.plain = blank, plain
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        bwd = ctc_bwd_plain if ctx.plain else ctc_loss_bwd
        grad = bwd(*ctx.saved_tensors, grad_nll.contiguous(), ctx.blank)
        return grad, None, None, None, None, None


def ctc_loss_plain(logits, logit_lengths, labels, label_lengths,
                   blank: int = 0):
    """The twin: per-sample NLL (B,) of logits (B, T, V) in their dtype,
    with the hand-written backward, on any device."""
    _check(logits, logit_lengths, labels, label_lengths)
    if logits.device.type == "cpu":
        warm_exp()
    return CtcLossFn.apply(logits, logit_lengths, labels, label_lengths,
                           blank, True)


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank: int = 0):
    """Per-sample CTC NLL (B,) of fp32 logits (B, T, V), zero for a sample
    that is infeasible or not finite (its gradient zero as well); labels
    (B, L) padded with any value past ``label_lengths``. On the CPU the
    twins, on a CUDA device the kernels."""
    _check(logits, logit_lengths, labels, label_lengths)
    if logits.dtype != torch.float32:
        raise TypeError(f"ctc_loss takes fp32 logits, got {logits.dtype}")
    return CtcLossFn.apply(logits.contiguous(), logit_lengths, labels,
                           label_lengths, blank, False)
