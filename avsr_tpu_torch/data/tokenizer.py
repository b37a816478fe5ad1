"""SentencePiece-unigram tokenization without the sentencepiece C++ library.

The port's copy of ``avsr_tpu/data/tokenizer.py``. The reference
(``src/tokenizer/spm_tokenizer.py:22-54``) wraps
``sentencepiece.SentencePieceProcessor`` around a unigram-5000 model and then
remaps pieces to ids through ``unigram5000_units.txt`` (piece -> id, with
``<unk>`` = 1 fallback; id 0 reserved for the CTC blank and the last id for
``<eos>``). We reproduce that stack natively:

* a minimal protobuf wire-format reader for the SentencePiece ``ModelProto``
  (field 1 = repeated ``SentencePiece {piece=1: string, score=2: float,
  type=3: enum}``) — the format is stable and public;
* text normalization equivalent to the default ``nmt_nfkc`` pipeline for the
  ASCII-uppercase transcripts this model consumes: NFKC, whitespace collapse,
  dummy-prefix, ``▁`` escaping;
* exact unigram Viterbi segmentation (max sum of piece log-probs), with
  consecutive unknown characters fused into one piece as SentencePiece does.

Model assets are *data shipped with the upstream checkpoint*, not code; they
are located at runtime via explicit paths, ``AVSR_SPM_DIR`` (read when this
module is imported) or the repository's ``assets/spm/unigram``.
"""

from __future__ import annotations

import os
import struct
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

WORD_BOUNDARY = "▁"  # ▁

_DEFAULT_ASSET_DIRS = (
    os.environ.get("AVSR_SPM_DIR", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "spm", "unigram"),
)


def _find_asset(filename: str) -> str:
    for d in _DEFAULT_ASSET_DIRS:
        if d and os.path.isfile(os.path.join(d, filename)):
            return os.path.join(d, filename)
    raise FileNotFoundError(
        f"SentencePiece asset {filename!r} not found; set AVSR_SPM_DIR or pass "
        "explicit paths to TextTransform."
    )


# ---------------------------------------------------------------------------
# Protobuf wire-format parsing (only what ModelProto needs).
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int) over a message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
        elif wire == 5:  # 32-bit
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


@dataclass(frozen=True)
class SpmPiece:
    piece: str
    score: float
    type: int  # 1=normal 2=unknown 3=control 4=user_defined 6=byte


def parse_model_proto(path: str) -> List[SpmPiece]:
    """Parse the ``pieces`` list out of a serialized SentencePiece model."""
    with open(path, "rb") as f:
        blob = f.read()
    pieces: List[SpmPiece] = []
    for field, wire, val in _iter_fields(blob):
        if field == 1 and wire == 2:  # repeated SentencePiece
            piece, score, ptype = "", 0.0, 1
            for sf, sw, sv in _iter_fields(val):
                if sf == 1 and sw == 2:
                    piece = sv.decode("utf-8")
                elif sf == 2 and sw == 5:
                    score = struct.unpack("<f", sv)[0]
                elif sf == 3 and sw == 0:
                    ptype = sv
            pieces.append(SpmPiece(piece, score, ptype))
    if not pieces:
        raise ValueError(f"no sentencepiece pieces parsed from {path}")
    return pieces


# ---------------------------------------------------------------------------
# Unigram model: normalization + Viterbi segmentation.
# ---------------------------------------------------------------------------


class SpmUnigram:
    """Unigram SentencePiece encoder (EncodeAsPieces-compatible)."""

    def __init__(self, pieces: Sequence[SpmPiece]):
        self.pieces = list(pieces)
        self.scores: Dict[str, float] = {}
        self.max_piece_len = 1
        unk = None
        for p in pieces:
            if p.type == 2:
                unk = p
            elif p.type in (1, 4):  # normal / user-defined
                self.scores[p.piece] = p.score
                self.max_piece_len = max(self.max_piece_len, len(p.piece))
        min_score = min(self.scores.values()) if self.scores else 0.0
        # SentencePiece scores unknown chars at min_score - 10.
        self.unk_piece = unk.piece if unk is not None else "<unk>"
        self.unk_score = min_score - 10.0

    @staticmethod
    def normalize(text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())  # collapse/trim whitespace runs
        if not text:
            return ""
        return WORD_BOUNDARY + text.replace(" ", WORD_BOUNDARY)

    def encode_pieces(self, text: str) -> List[str]:
        s = self.normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = -1e18
        best = np.full(n + 1, NEG)
        best[0] = 0.0
        back: List[tuple[int, bool]] = [(0, False)] * (n + 1)  # (start, is_unk)
        for end in range(1, n + 1):
            lo = max(0, end - self.max_piece_len)
            for start in range(lo, end):
                if best[start] == NEG:
                    continue
                sc = self.scores.get(s[start:end])
                if sc is not None and best[start] + sc > best[end]:
                    best[end] = best[start] + sc
                    back[end] = (start, False)
            # single-char unknown fallback
            if best[end - 1] != NEG and best[end - 1] + self.unk_score > best[end]:
                best[end] = best[end - 1] + self.unk_score
                back[end] = (end - 1, True)

        segments: List[tuple[str, bool]] = []
        end = n
        while end > 0:
            start, is_unk = back[end]
            segments.append((s[start:end], is_unk))
            end = start
        segments.reverse()

        # Fuse runs of consecutive unknown characters into a single piece,
        # matching SentencePiece's decoder-side unk merging.
        out: List[str] = []
        prev_unk = False
        for piece, is_unk in segments:
            if is_unk and prev_unk:
                out[-1] += piece
            else:
                out.append(piece)
            prev_unk = is_unk
        return out


class TextTransform:
    """Text <-> token-id mapping matching the reference TextTransform.

    token_list = ["<blank>"] + units + ["<eos>"]; ids come from the units
    file (piece -> id, <unk> = 1), odim = len(token_list) = 5049 for the
    shipped unigram5000 assets.
    """

    def __init__(self, sp_model_path: str | None = None, dict_path: str | None = None):
        sp_model_path = sp_model_path or _find_asset("unigram5000.model")
        dict_path = dict_path or _find_asset("unigram5000_units.txt")
        self.spm = SpmUnigram(parse_model_proto(sp_model_path))
        self.hashmap: Dict[str, int] = {}
        with open(dict_path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if parts:
                    self.hashmap[parts[0]] = int(parts[-1])
        self.token_list = ["<blank>"] + list(self.hashmap.keys()) + ["<eos>"]
        self.unk_id = self.hashmap["<unk>"]
        self.ignore_id = -1

    @property
    def vocab_size(self) -> int:
        return len(self.token_list)

    @property
    def eos_id(self) -> int:
        return len(self.token_list) - 1

    def tokenize(self, text: str) -> np.ndarray:
        pieces = self.spm.encode_pieces(text)
        ids = [self.hashmap.get(p, self.unk_id) for p in pieces]
        return np.asarray(ids, dtype=np.int32)

    def post_process(self, token_ids) -> str:
        ids = np.asarray(token_ids).reshape(-1)
        ids = ids[ids != self.ignore_id]
        text = "".join(self.token_list[i] for i in ids)
        return text.replace("<space>", " ").replace(WORD_BOUNDARY, " ").strip()
