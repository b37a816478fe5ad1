"""Pure-Python SentencePiece unigram model training.

The port's copy of ``avsr_tpu/data/spm_train.py``, over the port's own
modules (it imports nothing of the JAX package).

Counterpart of the reference's offline tokenizer-training step
(src/tokenizer/spm/train.sh -> spm_train.py -> the
sentencepiece C++ trainer with --model_type=unigram). Implements the
unigram-LM training algorithm (Kudo 2018): substring seed vocabulary ->
EM over the segmentation lattice -> loss-based pruning to the target
vocabulary, and serializes the result as a protobuf ``ModelProto`` that
``avsr_tpu_torch.data.tokenizer.parse_model_proto`` (and real sentencepiece)
can read back.

Scope: exact algorithmic shape at corpus sizes used for unit training and
recipe reproduction. The C++ trainer's suffix-array seeding and threading
make it faster at the 100M-sentence scale of train.sh; results here are
equivalent-quality, not bit-identical.
"""

from __future__ import annotations

import math
import struct
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

from avsr_tpu_torch.data.tokenizer import SpmPiece, SpmUnigram, WORD_BOUNDARY

_NEG = -1e18


def _corpus_words(lines: Iterable[str]) -> Counter:
    """Normalize lines and count boundary-prefixed words (split_by_whitespace
    semantics: pieces never span a word boundary)."""
    words: Counter = Counter()
    for line in lines:
        norm = SpmUnigram.normalize(line)
        if not norm:
            continue
        for w in norm.split(WORD_BOUNDARY):
            if w:
                words[WORD_BOUNDARY + w] += 1
    return words


def _seed_vocab(words: Counter, seed_size: int, max_piece_len: int) -> Dict[str, float]:
    """Candidate pieces: frequent substrings scored by freq * len (the
    standard approximation of the suffix-array seeding)."""
    counts: Counter = Counter()
    # words are single boundary-prefixed tokens ("▁WORD"), so no candidate
    # substring can contain an interior boundary marker
    for word, freq in words.items():
        n = len(word)
        for i in range(n):
            top = min(n, i + max_piece_len)
            for j in range(i + 1, top + 1):
                counts[word[i:j]] += freq
    chars = {w[i] for w in words for i in range(len(w))}
    scored = sorted(
        ((c * len(p), p) for p, c in counts.items() if len(p) > 1),
        reverse=True,
    )
    vocab = {p: float(c) for c, p in scored[: max(0, seed_size - len(chars))]}
    for ch in chars:  # single characters are always kept (coverage floor)
        vocab[ch] = float(counts.get(ch, 1))
    total = sum(vocab.values())
    return {p: math.log(c / total) for p, c in vocab.items()}


def _lattice_spans(word: str, scores: Dict[str, float], max_len: int):
    """All (start, end, logp) arcs over `word` present in the vocab."""
    n = len(word)
    arcs = []
    for i in range(n):
        for j in range(i + 1, min(n, i + max_len) + 1):
            sc = scores.get(word[i:j])
            if sc is not None:
                arcs.append((i, j, word[i:j], sc))
    return arcs


def _forward_backward(word: str, freq: float, scores: Dict[str, float],
                      max_len: int, expected: Dict[str, float]) -> float:
    """Accumulate expected piece counts for one word; returns its log-evidence."""
    n = len(word)
    arcs = _lattice_spans(word, scores, max_len)
    alpha = [_NEG] * (n + 1)
    alpha[0] = 0.0
    by_end: Dict[int, list] = defaultdict(list)
    by_start: Dict[int, list] = defaultdict(list)
    for a in arcs:
        by_end[a[1]].append(a)
        by_start[a[0]].append(a)
    for end in range(1, n + 1):
        vals = [alpha[i] + sc for i, _, _, sc in by_end[end] if alpha[i] > _NEG / 2]
        if vals:
            m = max(vals)
            alpha[end] = m + math.log(sum(math.exp(v - m) for v in vals))
    if alpha[n] <= _NEG / 2:
        return 0.0  # unsegmentable (shouldn't happen with char coverage)
    beta = [_NEG] * (n + 1)
    beta[n] = 0.0
    for start in range(n - 1, -1, -1):
        vals = [beta[j] + sc for _, j, _, sc in by_start[start] if beta[j] > _NEG / 2]
        if vals:
            m = max(vals)
            beta[start] = m + math.log(sum(math.exp(v - m) for v in vals))
    z = alpha[n]
    for i, j, piece, sc in arcs:
        if alpha[i] > _NEG / 2 and beta[j] > _NEG / 2:
            expected[piece] += freq * math.exp(alpha[i] + sc + beta[j] - z)
    return freq * z


def _viterbi_best(word: str, scores: Dict[str, float], max_len: int,
                  skip: str | None = None) -> Tuple[float, List[str]]:
    """Best segmentation (logp, pieces); optionally pretend `skip` is absent."""
    n = len(word)
    best = [_NEG] * (n + 1)
    best[0] = 0.0
    back = [0] * (n + 1)
    for end in range(1, n + 1):
        for i in range(max(0, end - max_len), end):
            if best[i] <= _NEG / 2:
                continue
            piece = word[i:end]
            if piece == skip:
                continue
            sc = scores.get(piece)
            if sc is not None and best[i] + sc > best[end]:
                best[end] = best[i] + sc
                back[end] = i
    if best[n] <= _NEG / 2:
        return _NEG, []
    pieces = []
    end = n
    while end > 0:
        pieces.append(word[back[end]:end])
        end = back[end]
    return best[n], pieces[::-1]


def _run_em(words: Counter, scores: Dict[str, float], max_len: int,
            iters: int = 2) -> Dict[str, float]:
    for _ in range(iters):
        expected: Dict[str, float] = defaultdict(float)
        for word, freq in words.items():
            _forward_backward(word, freq, scores, max_len, expected)
        total = sum(expected.values())
        if total <= 0:
            return scores
        kept = {}
        for piece in scores:
            c = expected.get(piece, 0.0)
            if c > 1e-9 or len(piece) == 1:
                kept[piece] = math.log(max(c, 1e-9) / total)
        scores = kept
    return scores


def _prune(words: Counter, scores: Dict[str, float], max_len: int,
           target: int, shrink: float = 0.75) -> Dict[str, float]:
    """Drop the pieces whose removal least hurts the Viterbi corpus likelihood."""
    while len(scores) > target:
        usage: Dict[str, float] = defaultdict(float)
        for word, freq in words.items():
            _, pieces = _viterbi_best(word, scores, max_len)
            for p in pieces:
                usage[p] += freq
        # loss of removing piece p: its Viterbi usage * (score(p) - best
        # alternative segmentation of p without itself)
        losses = []
        for piece, sc in scores.items():
            if len(piece) == 1:
                continue  # character coverage floor
            if usage.get(piece, 0.0) == 0.0:
                losses.append((0.0, piece))
                continue
            alt, _ = _viterbi_best(piece, scores, max_len, skip=piece)
            losses.append((usage[piece] * (sc - alt), piece))
        if not losses:
            break
        losses.sort()
        n_single = sum(1 for p in scores if len(p) == 1)
        keep_multi = max(target - n_single, int(len(losses) * shrink))
        drop = {p for _, p in losses[: len(losses) - keep_multi]}
        if not drop:
            break
        scores = {p: s for p, s in scores.items() if p not in drop}
        scores = _run_em(words, scores, max_len, iters=1)
    return scores


def train_unigram(
    lines: Iterable[str],
    vocab_size: int = 5000,
    max_piece_len: int = 16,
    seed_size: int | None = None,
    em_iters: int = 2,
) -> List[SpmPiece]:
    """Train a unigram model; returns the ModelProto pieces list.

    Layout matches sentencepiece defaults: ids 0/1/2 are <unk>/<s>/</s>
    (train.sh then remaps via the units file: CTC blank 0, <unk> 1).
    """
    words = _corpus_words(lines)
    if not words:
        raise ValueError("empty training corpus")
    n_reserved = 3
    n_pieces = vocab_size - n_reserved
    scores = _seed_vocab(words, seed_size or max(n_pieces * 4, 1000), max_piece_len)
    scores = _run_em(words, scores, max_piece_len, iters=em_iters)
    scores = _prune(words, scores, max_piece_len, target=n_pieces)
    if len(scores) > n_pieces:  # final trim by probability, chars protected
        multi = sorted(
            ((s, p) for p, s in scores.items() if len(p) > 1), reverse=True
        )
        n_single = sum(1 for p in scores if len(p) == 1)
        keep = {p for _, p in multi[: max(0, n_pieces - n_single)]}
        scores = {p: s for p, s in scores.items() if len(p) == 1 or p in keep}
        scores = _run_em(words, scores, max_piece_len, iters=1)
    pieces = [
        SpmPiece("<unk>", 0.0, 2),
        SpmPiece("<s>", 0.0, 3),
        SpmPiece("</s>", 0.0, 3),
    ]
    for p, s in sorted(scores.items(), key=lambda kv: -kv[1]):
        pieces.append(SpmPiece(p, s, 1))
    return pieces


# ---------------------------------------------------------------------------
# ModelProto serialization (inverse of tokenizer.parse_model_proto)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def serialize_model_proto(pieces: Sequence[SpmPiece]) -> bytes:
    """Serialize pieces as ModelProto field 1 (SentencePiece sub-messages)."""
    blob = bytearray()
    for p in pieces:
        sub = bytearray()
        sub += _len_delim(1, p.piece.encode("utf-8"))
        sub += _varint((2 << 3) | 5) + struct.pack("<f", p.score)
        if p.type != 1:
            sub += _varint(3 << 3) + _varint(p.type)
        blob += _len_delim(1, bytes(sub))
    return bytes(blob)


def save_model(pieces: Sequence[SpmPiece], path: str) -> None:
    with open(path, "wb") as f:
        f.write(serialize_model_proto(pieces))


def train_and_save(
    input_path: str,
    model_prefix: str,
    vocab_size: int = 5000,
    max_piece_len: int = 16,
) -> None:
    """train.sh equivalent: train the model and derive the units file
    (<unk> 1; corpus pieces from id 2; id 0 reserved for the CTC blank)."""
    from avsr_tpu_torch.data.spm_tools import build_units

    with open(input_path, encoding="utf-8") as f:
        lines = f.readlines()
    pieces = train_unigram(lines, vocab_size, max_piece_len)
    model_path = model_prefix + ".model"
    save_model(pieces, model_path)
    with open(input_path, encoding="utf-8") as f:
        units = build_units(model_path, f)
    with open(model_prefix + "_units.txt", "w", encoding="utf-8") as f:
        f.write("\n".join(units) + "\n")


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Train a unigram SPM model")
    parser.add_argument("--input", required=True)
    parser.add_argument("--model_prefix", required=True)
    parser.add_argument("--vocab_size", type=int, default=5000)
    parser.add_argument("--max_piece_len", type=int, default=16)
    args = parser.parse_args()
    train_and_save(args.input, args.model_prefix, args.vocab_size,
                   args.max_piece_len)


if __name__ == "__main__":
    main()
