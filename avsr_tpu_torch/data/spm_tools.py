"""SPM tooling: encode text to pieces / build units files (reference spm/).

The port's copy of ``avsr_tpu/data/spm_tools.py``, over the port's own
modules (it imports nothing of the JAX package).

Counterpart of the reference's src/tokenizer/spm/{spm_encode.py,train.sh}
runtime half: encoding text with an existing unigram model and deriving the
units (piece -> id) file from a corpus, using the native tokenizer (no
sentencepiece binary needed). Training new unigram models lives in
avsr_tpu_torch.data.spm_train (pure-Python EM trainer + ModelProto writer).
"""

from __future__ import annotations

import argparse
import sys
from typing import Iterable, Iterator

from avsr_tpu_torch.data.tokenizer import SpmUnigram, parse_model_proto


def encode_lines(model_path: str, lines: Iterable[str]) -> Iterator[str]:
    spm = SpmUnigram(parse_model_proto(model_path))
    for line in lines:
        yield " ".join(spm.encode_pieces(line.strip()))


def build_units(model_path: str, lines: Iterable[str]) -> list[str]:
    """Derive the units file body: sorted unique pieces with ids from 2
    (0 = CTC blank, 1 = <unk>), matching spm/train.sh."""
    pieces = set()
    spm = SpmUnigram(parse_model_proto(model_path))
    for line in lines:
        pieces.update(spm.encode_pieces(line.strip()))
    out = ["<unk> 1"]
    for i, piece in enumerate(sorted(pieces)):
        out.append(f"{piece} {i + 2}")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description="Encode text with an SPM model")
    parser.add_argument("--model", required=True)
    parser.add_argument("--units", action="store_true",
                        help="emit a units (piece -> id) file instead of pieces")
    parser.add_argument("input", nargs="?", default="-")
    args = parser.parse_args()
    stream = sys.stdin if args.input == "-" else open(args.input)
    if args.units:
        print("\n".join(build_units(args.model, stream)))
    else:
        for line in encode_lines(args.model, stream):
            print(line)


if __name__ == "__main__":
    main()
