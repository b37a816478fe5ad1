"""Speech2Text tokenizer (MuAViC family) without HF tokenizers/sentencepiece.

The port's copy of ``avsr_tpu/data/s2t_tokenizer.py``, over the port's
``data/tokenizer``. Loads the HF Speech2TextTokenizer assets shipped with the checkpoint
(vocab.json + sentencepiece.bpe.model) and provides decode with
skip-special-tokens — the only operation the evaluation path needs
(reference script/evaluation.py:205) — plus SPM-based encode for training.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence

import numpy as np

from avsr_tpu_torch.data.tokenizer import SpmUnigram, parse_model_proto


class Speech2TextTokenizer:
    def __init__(self, vocab_path: str, spm_path: str | None = None):
        with open(vocab_path, encoding="utf-8") as f:
            self.vocab = json.load(f)
        self.id_to_piece = {v: k for k, v in self.vocab.items()}
        self.special = {"<s>", "</s>", "<pad>", "<unk>"}
        self.spm = None
        if spm_path and os.path.exists(spm_path):
            self.spm = SpmUnigram(parse_model_proto(spm_path))

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "Speech2TextTokenizer":
        return cls(
            os.path.join(model_dir, "vocab.json"),
            os.path.join(model_dir, "sentencepiece.bpe.model"),
        )

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        pieces = []
        for i in np.asarray(ids).reshape(-1):
            piece = self.id_to_piece.get(int(i), "<unk>")
            if skip_special_tokens and piece in self.special:
                continue
            pieces.append(piece)
        return "".join(pieces).replace("▁", " ").strip()

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def encode(self, text: str) -> List[int]:
        if self.spm is None:
            raise ValueError("no sentencepiece model loaded for encoding")
        unk = self.vocab.get("<unk>", 3)
        return [self.vocab.get(p, unk) for p in self.spm.encode_pieces(text)]
