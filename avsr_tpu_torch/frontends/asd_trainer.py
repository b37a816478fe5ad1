"""ASD training and evaluation loops (reference
src/talking_detector/ASD.py:11-103).

Counterpart of ``avsr_tpu/frontends/asd_trainer.py``: one train step is
both heads' loss, the backward pass, an Adam update and the BN batch
statistics' update, at the per-epoch StepLR learning rate (gamma 0.95) and
the loss-smoothing schedule r = 1.3 - 0.02*(epoch-1). Evaluation is a
batched score pass; the AVA mAP is computed natively (the reference shells
out to utils/get_ava_active_speaker_performance.py, ASD.py:79-81).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from avsr_tpu_torch.frontends.asd import ASDModel
from avsr_tpu_torch.frontends.weights import released_state


def _bce(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """torch nn.BCELoss on probabilities as the JAX package computes it:
    p clamped to [1e-7, 1 - 1e-7], mean reduction."""
    p = p.clamp(1e-7, 1.0 - 1e-7)
    return -torch.mean(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """Frame-level average precision (the AVA active-speaker metric the
    reference computes via an external script, ASD.py:79-81)."""
    scores = np.asarray(scores, np.float64).ravel()
    y = np.asarray(labels).ravel().astype(np.float64)
    order = np.argsort(-scores, kind="stable")
    y = y[order]
    tp = np.cumsum(y)
    precision = tp / (np.arange(len(y)) + 1.0)
    denom = y.sum()
    return float((precision * y).sum() / denom) if denom else 0.0


@dataclass
class ASDTrainer:
    """Reference-equivalent optimizer loop: Adam lr 1e-3, StepLR gamma 0.95
    per epoch, loss = lossAV + 0.5 * lossV (ASD.py:12-38), on ``device``
    (``cuda`` unless the caller asks for the CPU). The model starts from
    torch's initialisation under ``torch.manual_seed(seed)``."""

    lr: float = 0.001
    lr_decay: float = 0.95
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self.model = ASDModel()
        self.model.to(self.device)
        self._reset_optimizer()

    def _reset_optimizer(self) -> None:
        self.opt = torch.optim.Adam(self.model.parameters(), lr=self.lr)

    # ---------------- state ----------------

    def load_state_dict(self, state: dict) -> None:
        """The port's ``ASDModel`` state dict (``asd_flax_to_torch`` of JAX
        variables, say); the optimizer starts afresh."""
        self.model.load_state_dict(state, strict=True)
        self._reset_optimizer()

    def load_torch(self, state: dict) -> None:
        """A reference talking_detector checkpoint state dict (keys
        'model.*' / 'lossAV.*' / 'lossV.*', ASD.py:89-103), arrays or
        tensors; ``num_batches_tracked`` is dropped."""
        self.load_state_dict(released_state(state))

    def _upload(self, *arrays):
        return [torch.as_tensor(np.asarray(a, np.float32)).to(self.device)
                for a in arrays]

    # ---------------- steps ----------------

    def train_step(self, audio, visual, labels, r: float, lr: float):
        """One step on a batch; returns (loss, loss_av, loss_v, correct)
        as Python numbers (one fetch from the device)."""
        audio, visual, y = self._upload(audio, visual, labels)
        y = y.reshape(-1)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.model.train()
        la, lv = self.model.train_logits(audio, visual, train=True)
        la, lv = la.reshape(-1, 2), lv.reshape(-1, 2)
        # reference loss.py: BCE on softmax(x/r)[:, 1]
        loss_av = _bce(F.softmax(la / r, -1)[:, 1], y)
        loss_v = _bce(F.softmax(lv / r, -1)[:, 1], y)
        loss = loss_av + 0.5 * loss_v
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        for gru in (self.model.model.GRU.gru_forward,
                    self.model.model.GRU.gru_backward):
            # the hidden side's r and z biases are not flax parameters
            gru.bias_hh_l0.grad[: 2 * gru.hidden_size] = 0.0
        self.opt.step()
        with torch.no_grad():
            correct = (torch.round(F.softmax(la, -1)[:, 1]) == y).sum()
            metrics = torch.stack([loss, loss_av, loss_v, correct.float()])
        return tuple(metrics.cpu().tolist())

    @torch.no_grad()
    def score(self, audio, visual) -> np.ndarray:
        """Eval predScore = softmax(lossAV logits)[..., 1] (loss.py:23),
        (B, T), with the running statistics."""
        audio, visual = self._upload(audio, visual)
        self.model.eval()
        la, _ = self.model.train_logits(audio, visual, train=False)
        return F.softmax(la, -1)[..., 1].cpu().numpy()

    # ---------------- epoch loops ----------------

    def train_network(
        self, loader: Iterable, epoch: int, verbose: bool = True
    ) -> Tuple[float, float]:
        """One epoch; returns (mean loss, lr) like the reference (:21-53)."""
        lr = self.lr * self.lr_decay ** (epoch - 1)  # StepLR(step_size=1)
        r = 1.3 - 0.02 * (epoch - 1)
        tot = np.zeros(3)
        top1 = n_frames = 0
        num = 0
        for num, (audio, visual, labels) in enumerate(loader, start=1):
            loss, loss_av, loss_v, correct = self.train_step(
                audio, visual, labels, r, lr)
            tot += (loss, loss_av, loss_v)
            top1 += correct
            n_frames += int(np.asarray(labels).size)
            if verbose:
                sys.stderr.write(
                    time.strftime("%m-%d %H:%M:%S")
                    + " [%2d] r: %2f, Lr: %5f," % (epoch, r, lr)
                    + " LossV: %.5f, LossAV: %.5f, Loss: %.5f, ACC: %2.2f%% \r"
                    % (tot[2] / num, tot[1] / num, tot[0] / num,
                       100 * top1 / n_frames)
                )
                sys.stderr.flush()
        if verbose:
            sys.stderr.write("\n")
        return (tot[0] / max(num, 1), lr)

    def evaluate_network(
        self,
        loader: Iterable,
        eval_csv_save: Optional[str] = None,
        eval_orig: Optional[str] = None,
    ):
        """Batched score pass. Returns the per-frame scores; when eval_orig
        (the AVA ground-truth CSV) is given, also writes the prediction CSV
        in the reference format and returns (scores, mAP) (:55-82)."""
        preds = []
        for audio, visual, *_ in loader:
            preds.extend(self.score(audio, visual).reshape(-1).tolist())
        preds = np.asarray(preds, np.float32)
        if eval_orig is None:
            return preds
        import pandas

        eval_res = pandas.read_csv(eval_orig)
        truth = (eval_res["label"] == "SPEAKING_AUDIBLE").to_numpy()
        out = eval_res.copy()
        out["score"] = pandas.Series(preds)
        out["label"] = pandas.Series(["SPEAKING_AUDIBLE"] * len(preds))
        for col in ("label_id", "instance_id"):
            if col in out:
                out.drop([col], axis=1, inplace=True)
        if eval_csv_save is not None:
            out.to_csv(eval_csv_save, index=False)
        return preds, average_precision(preds, truth)

    # ---------------- checkpoint ----------------

    def save(self, path: str) -> None:
        """The model's state dict (parameters and running statistics)."""
        torch.save(self.model.state_dict(), path)

    def load(self, path: str) -> None:
        """A state dict written by ``save``; the optimizer starts afresh."""
        self.load_state_dict(torch.load(path, map_location=self.device,
                                        weights_only=True))
