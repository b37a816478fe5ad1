"""Word/character error rate metrics (the port's copy of
``avsr_tpu/data/wer.py``).

``wer(reference, hypothesis)`` matches jiwer semantics (reference
script/evaluation.py:402): over lists it aggregates the sum of word-level
edit distances across pairs divided by total reference word count.
``ErrorCalculator`` is the training-time CER/WER reporter
(reference src/nets/e2e_asr_common.py:100).
"""

from __future__ import annotations

from itertools import groupby
from typing import List, Optional, Sequence, Union

import numpy as np


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Levenshtein distance between token sequences (unit costs)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1, dtype=np.int32)
    cur = np.empty(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        cur[0] = i
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ref[i - 1] != hyp[j - 1])
            cur[j] = min(sub, prev[j] + 1, cur[j - 1] + 1)
        prev, cur = cur, prev
    return int(prev[m])


def wer(
    reference: Union[str, List[str]],
    hypothesis: Union[str, List[str]],
) -> float:
    """Aggregate word error rate over one or more utterance pairs."""
    refs = [reference] if isinstance(reference, str) else list(reference)
    hyps = [hypothesis] if isinstance(hypothesis, str) else list(hypothesis)
    if len(refs) != len(hyps):
        raise ValueError(f"got {len(refs)} references but {len(hyps)} hypotheses")
    total_err = 0
    total_words = 0
    for r, h in zip(refs, hyps):
        r_words, h_words = r.split(), h.split()
        total_err += edit_distance(r_words, h_words)
        total_words += len(r_words)
    if total_words == 0:
        raise ValueError("empty reference")
    return total_err / total_words


class ErrorCalculator:
    """Training-time CER/WER over padded id sequences (e2e_asr_common.py:100)."""

    def __init__(self, char_list: Sequence[str], sym_space: str, sym_blank: str,
                 report_cer: bool = False, report_wer: bool = False):
        self.char_list = list(char_list)
        self.space = sym_space
        self.blank = sym_blank
        self.report_cer = report_cer
        self.report_wer = report_wer
        self.idx_blank = self.char_list.index(sym_blank)
        self.idx_space = (
            self.char_list.index(sym_space) if sym_space in self.char_list else None
        )

    def _to_text(self, ids, collapse: bool = False) -> str:
        if collapse:
            ids = [k for k, _ in groupby(ids)]
        chars = [
            self.char_list[int(i)]
            for i in ids
            if int(i) not in (-1, self.idx_blank, self.idx_space)
        ]
        return "".join(chars)

    def calculate_cer_ctc(self, ys_hat, ys_pad) -> Optional[float]:
        cers, ref_lens = [], []
        for hyp, ref in zip(ys_hat, ys_pad):
            h = self._to_text(hyp, collapse=True)
            r = self._to_text(ref)
            if r:
                cers.append(edit_distance(h, r))
                ref_lens.append(len(r))
        return float(sum(cers) / sum(ref_lens)) if cers else None

    def convert_to_char(self, ys_hat, ys_pad):
        seqs_hat, seqs_true = [], []
        for hyp, ref in zip(ys_hat, ys_pad):
            ref = [int(i) for i in ref if int(i) != -1]
            hyp = [int(i) for i in hyp][: len(ref)]
            text_hat = "".join(self.char_list[i] for i in hyp)
            text_true = "".join(self.char_list[i] for i in ref)
            seqs_hat.append(
                text_hat.replace(self.space, " ").replace(self.blank, "")
            )
            seqs_true.append(text_true.replace(self.space, " "))
        return seqs_hat, seqs_true

    def calculate_cer(self, seqs_hat, seqs_true) -> float:
        dists = [
            edit_distance(h.replace(" ", ""), r.replace(" ", ""))
            for h, r in zip(seqs_hat, seqs_true)
        ]
        lens = [len(r.replace(" ", "")) for r in seqs_true]
        return float(sum(dists) / sum(lens))

    def calculate_wer(self, seqs_hat, seqs_true) -> float:
        dists = [
            edit_distance(h.split(), r.split()) for h, r in zip(seqs_hat, seqs_true)
        ]
        lens = [len(r.split()) for r in seqs_true]
        return float(sum(dists) / sum(lens))

    def __call__(self, ys_hat, ys_pad, is_ctc: bool = False):
        if is_ctc:
            return self.calculate_cer_ctc(ys_hat, ys_pad)
        if not self.report_cer and not self.report_wer:
            return None, None
        seqs_hat, seqs_true = self.convert_to_char(ys_hat, ys_pad)
        cer = self.calculate_cer(seqs_hat, seqs_true) if self.report_cer else None
        wer = self.calculate_wer(seqs_hat, seqs_true) if self.report_wer else None
        return cer, wer
