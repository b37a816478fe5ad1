"""ASD-score hysteresis segmentation (chunking long videos for inference).

Behavior-compatible re-implementation of the reference chunker
(reference src/talking_detector/segmentation.py:23-111): hysteresis
thresholding over per-frame active-speaker-detection scores, gap filling,
minimum-duration dropping, and ceil-division splitting of long regions.
Frame rate is 25 fps. The port's copy of
``avsr_tpu/frontends/segmentation.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

FPS = 25

CENTRAL_PARAMS = {
    "onset": 1.0,
    "offset": 0.8,
    "min_duration_on": 1.0,
    "min_duration_off": 0.5,
    "max_chunk_size": 10,
    "min_chunk_size": 1,
}

EGO_PARAMS = {
    "onset": 2.4,
    "offset": 1.6,
    "min_duration_on": 1.0,
    "min_duration_off": 0.5,
    "max_chunk_size": 10,
    "min_chunk_size": 1,
}


def segment_by_asd(asd: Dict[str, float], parameters: Dict | None = None) -> List[List[int]]:
    """Split per-frame ASD scores into speech segments (lists of frame ids)."""
    p = parameters or {}
    onset = p.get("onset", CENTRAL_PARAMS["onset"])
    offset = p.get("offset", CENTRAL_PARAMS["offset"])
    # note: the reference uses min_duration_on as the default for the off gap
    # too (segmentation.py:37) — keep that quirk for parity
    min_on = int(p.get("min_duration_on", CENTRAL_PARAMS["min_duration_on"]) * FPS)
    min_off = int(p.get("min_duration_off", CENTRAL_PARAMS["min_duration_on"]) * FPS)
    max_chunk = int(p.get("max_chunk_size", CENTRAL_PARAMS["max_chunk_size"]) * FPS)
    min_chunk = int(p.get("min_chunk_size", CENTRAL_PARAMS["min_chunk_size"]) * FPS)

    frames = sorted(int(f) for f in asd)
    if not frames:
        return []
    base = frames[0]

    # pass 1: hysteresis on/off regions
    regions: List[List[int]] = []
    current: List[int] | None = None
    for frame in frames:
        score = asd.get(str(frame), -1)
        rel = frame - base
        if current is None:
            if score > onset:
                current = [rel]
        elif score < offset:
            regions.append(current)
            current = None
        else:
            current.append(rel)
    if current is not None:
        regions.append(current)

    # pass 2: merge regions separated by short gaps
    merged: List[List[int]] = []
    if regions:
        cur = regions[0]
        for nxt in regions[1:]:
            if nxt[0] - cur[-1] - 1 <= min_off:
                cur.extend(nxt)
            else:
                merged.append(cur)
                cur = nxt
        merged.append(cur)

    # pass 3: drop short regions, split long ones by ceil division
    final: List[List[int]] = []
    for region in merged:
        n = len(region)
        if n < min_on:
            continue
        if n > max_chunk:
            pieces = math.ceil(n / max_chunk)
            size = math.ceil(n / pieces)
            for i in range(0, n, size):
                part = region[i : i + size]
                if len(part) >= min_chunk:
                    final.append(part)
        else:
            final.append(region)

    return [[f + base for f in seg] for seg in final]


def fixed_chunks(duration: float, max_length: float) -> List[tuple]:
    """Equal ceil-division windows (InferenceEngine.chunk_video :254-269)."""
    num = math.ceil(duration / max_length)
    size = math.ceil(duration / num)
    steps = int(duration * 100)
    step = int(size * 100)
    out = []
    for i in range(0, steps, step):
        out.append((i / 100, min((i + step) / 100, duration)))
    return out


def asd_chunks(
    asd: Dict[str, float], max_length: float = 15.0, parameters: Dict | None = None
) -> List[tuple]:
    """ASD-driven (start_s, end_s) segments normalized to track start
    (InferenceEngine.chunk_video :239-252)."""
    p = dict(parameters or {})
    p.setdefault("max_chunk_size", max_length)
    frames = sorted(int(f) for f in asd)
    if not frames:
        return []
    base = frames[0]
    segs = segment_by_asd(asd, p)
    return [((s[0] - base) / FPS, (s[-1] - base) / FPS) for s in segs]
