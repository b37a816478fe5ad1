"""Conversation-level speaker clustering for multi-speaker sessions (MCoRec).

Behavior-compatible re-implementation of the reference
(reference src/cluster/conv_spks.py): per-speaker activity segments
from ASD JSONs, pairwise overlap -> conversation score (1 - overlap ratio),
complete-linkage agglomerative clustering at distance threshold 1-0.7, plus
pairwise-F1 / ARI evaluation metrics (cluster/eval.py). The port's copy of
``avsr_tpu/frontends/cluster.py``; sklearn is imported where it is used.
"""

from __future__ import annotations

import json
from itertools import combinations
from typing import Dict, List, Sequence, Tuple

import numpy as np

from avsr_tpu_torch.frontends.segmentation import segment_by_asd

MAX_SPEAKERS = 8
MAX_CONVERSATIONS = 4
FPS = 25


def overlap_durations(
    segs1: Sequence[Tuple[float, float]], segs2: Sequence[Tuple[float, float]]
) -> Tuple[float, float]:
    """Total overlapped and non-overlapped speaking time of two speakers."""
    total1 = sum(e - s for s, e in segs1)
    total2 = sum(e - s for s, e in segs2)
    overlap = 0.0
    for s1, e1 in segs1:
        for s2, e2 in segs2:
            lo, hi = max(s1, s2), min(e1, e2)
            if hi > lo:
                overlap += hi - lo
    return overlap, total1 + total2 - 2 * overlap


def calculate_conversation_scores(
    speaker_segments: Dict[str, List[Tuple[float, float]]],
) -> np.ndarray:
    """(N, N) score matrix; high score = likely same conversation."""
    ids = list(speaker_segments)
    n = len(ids)
    scores = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            ov, nov = overlap_durations(
                speaker_segments[ids[i]], speaker_segments[ids[j]]
            )
            score = 1 - ov / (ov + nov) if ov + nov > 0 else 0.0
            scores[i, j] = scores[j, i] = score
    return scores


def cluster_speakers(
    scores: np.ndarray,
    speaker_ids: List[str],
    threshold: float = 0.7,
    n_clusters: int | None = None,
) -> Dict[str, int]:
    """Complete-linkage agglomerative clustering over 1-score distances."""
    from sklearn.cluster import AgglomerativeClustering

    if n_clusters is not None and n_clusters > MAX_CONVERSATIONS:
        raise ValueError(f"maximum number of conversations is {MAX_CONVERSATIONS}")
    distances = 1 - scores
    if n_clusters is None:
        algo = AgglomerativeClustering(
            n_clusters=None,
            distance_threshold=1 - threshold,
            metric="precomputed",
            linkage="complete",
        )
    else:
        algo = AgglomerativeClustering(
            n_clusters=min(n_clusters, MAX_CONVERSATIONS),
            metric="precomputed",
            linkage="complete",
        )
    labels = algo.fit_predict(distances)
    return {spk: int(lab) for spk, lab in zip(speaker_ids, labels)}


def get_speaker_activity_segments(
    asd_paths: List[str], uem_start: float, uem_end: float
) -> List[List[float]]:
    """Merge a speaker's track ASD JSONs and segment into speech intervals."""
    frames: Dict[str, float] = {}
    for path in sorted(asd_paths):
        with open(path) as f:
            frames.update(json.load(f))
    segments = [
        (int(seg[0]) / FPS, int(seg[-1]) / FPS) for seg in segment_by_asd(frames)
    ]
    out = []
    for start, end in segments:
        if end < uem_start:
            continue
        if start > uem_end:
            break
        out.append([start - uem_start, end - uem_start])
    return out


# ---------------------------------------------------------------------------
# clustering metrics (cluster/eval.py)
# ---------------------------------------------------------------------------


def pairwise_f1_score(true_labels: Sequence, pred_labels: Sequence) -> float:
    """F1 over same-cluster speaker pairs."""
    n = len(true_labels)
    tp = fp = fn = 0
    for i, j in combinations(range(n), 2):
        same_true = true_labels[i] == true_labels[j]
        same_pred = pred_labels[i] == pred_labels[j]
        tp += same_true and same_pred
        fp += same_pred and not same_true
        fn += same_true and not same_pred
    if tp == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * precision * recall / (precision + recall)


def pairwise_f1_score_per_speaker(
    true_labels: Sequence, pred_labels: Sequence
) -> List[float]:
    """Per-speaker pairwise F1 (each speaker scored over its own pairs)."""
    n = len(true_labels)
    out = []
    for i in range(n):
        tp = fp = fn = 0
        for j in range(n):
            if i == j:
                continue
            same_true = true_labels[i] == true_labels[j]
            same_pred = pred_labels[i] == pred_labels[j]
            tp += same_true and same_pred
            fp += same_pred and not same_true
            fn += same_true and not same_pred
        if tp == 0:
            out.append(0.0)
            continue
        precision = tp / (tp + fp)
        recall = tp / (tp + fn)
        out.append(2 * precision * recall / (precision + recall))
    return out


def adjusted_rand_index(true_labels: Sequence, pred_labels: Sequence) -> float:
    from sklearn.metrics import adjusted_rand_score

    return float(adjusted_rand_score(list(true_labels), list(pred_labels)))
