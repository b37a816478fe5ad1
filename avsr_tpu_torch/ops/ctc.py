"""CTC loss and label-smoothing loss (counterpart of ``avsr_tpu/ops/ctc.py``).

- CTC: torch.nn.CTCLoss(reduction='sum', zero_infinity=True) divided by the
  batch size (reference ctc.py:64-73): the mean of the per-sample NLL with
  non-finite samples zeroed. The per-sample NLL and its gradient come from
  ``ops/kernels/ctc_loss.ctc_loss`` (``csrc/ctc_loss.cu`` on the card, its
  plain twin on the CPU), which reads the lengths on the device, zeroes a
  sample whose alignment is infeasible (T < L + repeats) or whose NLL is
  not finite, gives it a zero gradient, as the JAX package does, and
  normalises its recursions so that the fp32 gradient stays near float64
  at any T.
- Label smoothing: KLDiv(log_softmax(x), smoothed one-hot) summed over
  non-padding positions, normalised by the batch size (reference
  label_smoothing_loss.py:13-62, normalize_length=False).
"""

from __future__ import annotations

import math

import torch

from avsr_tpu_torch.ops.kernels import ctc_loss as pctc


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Batch-mean CTC negative log-likelihood (zero_infinity semantics).

    logits (B, T, V) unnormalised; labels (B, L) padded with any value
    outside the valid region."""
    per_seq = pctc.ctc_loss(logits.float(), logit_lengths, labels,
                            label_lengths, blank=blank_id)
    return per_seq.sum() / logits.shape[0]


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1, ignore_id: int = -1,
                         normalize_length: bool = False) -> torch.Tensor:
    """KL(smoothed one-hot || softmax(logits)) with the reference's
    normalisation; logits (B, L, V), targets (B, L) with ignore_id pads."""
    b, l, v = logits.shape
    x = logits.reshape(-1, v).float()
    tgt = targets.reshape(-1)
    ignore = tgt == ignore_id
    logp = torch.log_softmax(x, dim=-1)
    confidence = 1.0 - smoothing
    low = smoothing / (v - 1)
    # KLDiv = sum_c p_c (log p_c - logp_c); p has two distinct values
    kl_other = low * (math.log(low) - logp)
    target_logp = logp.gather(1, torch.where(ignore, 0, tgt)[:, None])[:, 0]
    kl_sum = (kl_other.sum(-1) - low * (math.log(low) - target_logp)
              + confidence * (math.log(confidence) - target_logp))
    kl_sum = torch.where(ignore, 0.0, kl_sum)
    denom = (~ignore).sum().clamp_min(1) if normalize_length else b
    return kl_sum.sum() / denom


def th_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                ignore_id: int = -1) -> torch.Tensor:
    """Token accuracy over non-ignored positions (reference
    nets_utils.py:303)."""
    mask = targets != ignore_id
    correct = ((logits.argmax(dim=-1) == targets) & mask).sum()
    return correct / mask.sum().clamp_min(1)
