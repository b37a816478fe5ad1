"""Minimal WebVTT read/write (replaces the webvtt-py dependency); the
port's copy of ``avsr_tpu/data/vtt.py``.

Only the subset the evaluation pipeline needs: cue timestamps + text
(reference script/evaluation.py:272-278, 376-385, 414-434).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List

_TS = re.compile(
    r"(?:(\d+):)?(\d{2}):(\d{2})[.,](\d{3})"
)


@dataclass
class Cue:
    start: float
    end: float
    text: str


def parse_timestamp(ts: str) -> float:
    m = _TS.match(ts.strip())
    if not m:
        raise ValueError(f"bad vtt timestamp {ts!r}")
    h = int(m.group(1) or 0)
    return h * 3600 + int(m.group(2)) * 60 + int(m.group(3)) + int(m.group(4)) / 1000


def format_timestamp(t: float) -> str:
    hours = int(t // 3600)
    minutes = int((t % 3600) // 60)
    seconds = int(t % 60)
    millis = int((t - int(t)) * 1000)
    return f"{hours:02d}:{minutes:02d}:{seconds:02d}.{millis:03d}"


def parse(content: str) -> List[Cue]:
    cues: List[Cue] = []
    block: List[str] = []
    for raw in content.splitlines() + [""]:
        line = raw.strip("﻿").rstrip()
        if line:
            block.append(line)
            continue
        for i, bl in enumerate(block):
            if "-->" in bl:
                start_s, _, end_s = bl.partition("-->")
                text = "\n".join(block[i + 1 :])
                cues.append(
                    Cue(parse_timestamp(start_s), parse_timestamp(end_s), text)
                )
                break
        block = []
    return cues


def write(cues: List[Cue]) -> str:
    parts = ["WEBVTT", ""]
    for cue in cues:
        text = cue.text.strip()
        if not text:
            continue
        parts.append(f"{format_timestamp(cue.start)} --> {format_timestamp(cue.end)}")
        parts.append(text)
        parts.append("")
    return "\n".join(parts)
