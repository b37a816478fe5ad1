"""Face tracking + preprocessing file utilities.

The port's copy of ``avsr_tpu/frontends/tracker.py``: behavior-compatible
re-implementations of the remaining reference preprocessing helpers:
  - SimpleFaceTracker (ibug/face_detection/utils/simple_face_tracker.py:9):
    greedy IoU tracklet assignment via the Hungarian algorithm;
  - split_file (retinaface/utils.py:8): split ASD word transcripts into
    <=600-frame segments.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class SimpleFaceTracker:
    """IoU-based greedy tracklet assignment across frames."""

    def __init__(self, iou_threshold: float = 0.4, minimum_face_size: float = 0.0):
        self.iou_threshold = iou_threshold
        self.minimum_face_size = minimum_face_size
        self._tracklets: List[dict] = []
        self._counter = 0

    def __call__(self, face_boxes: np.ndarray) -> List[Optional[int]]:
        from scipy.optimize import linear_sum_assignment

        if face_boxes.size <= 0:
            self._tracklets = []
            return []
        areas = np.abs(
            (face_boxes[:, 2] - face_boxes[:, 0]) * (face_boxes[:, 3] - face_boxes[:, 1])
        )
        for t in self._tracklets:
            t["tracked"] = False
        dist_thresh = float(np.clip(1.0 - self.iou_threshold, 0.0, 1.0))
        min_area = max(self.minimum_face_size**2, np.finfo(float).eps)
        n, m = face_boxes.shape[0], len(self._tracklets)
        distances = np.full((n, m), 2.0 * min(n, m), float)
        for row, box in enumerate(face_boxes):
            if areas[row] < min_area:
                continue
            for col, t in enumerate(self._tracklets):
                tb = t["bbox"]
                x0 = max(min(box[0], box[2]), min(tb[0], tb[2]))
                y0 = max(min(box[1], box[3]), min(tb[1], tb[3]))
                x1 = min(max(box[2], box[0]), max(tb[2], tb[0]))
                y1 = min(max(box[3], box[1]), max(tb[3], tb[1]))
                if x1 <= x0 or y1 <= y0:
                    d = 1.0
                else:
                    inter = (x1 - x0) * (y1 - y0)
                    d = 1.0 - inter / float(areas[row] + t["area"] - inter)
                if d <= dist_thresh:
                    distances[row, col] = d

        ids: List[Optional[int]] = [None] * n
        for row, col in zip(*linear_sum_assignment(distances)):
            if distances[row, col] <= dist_thresh:
                t = self._tracklets[col]
                ids[row] = t["id"]
                t["bbox"] = face_boxes[row, :4].copy()
                t["area"] = areas[row]
                t["tracked"] = True
        self._tracklets = [t for t in self._tracklets if t["tracked"]]
        for idx, box in enumerate(face_boxes):
            if areas[idx] >= min_area and ids[idx] is None:
                self._counter += 1
                self._tracklets.append(
                    {"bbox": box[:4].copy(), "area": areas[idx],
                     "id": self._counter, "tracked": True}
                )
                ids[idx] = self._counter
        return ids

    def reset(self, reset_tracklet_counter: bool = True) -> None:
        self._tracklets = []
        if reset_tracklet_counter:
            self._counter = 0


def split_asd_transcript(filename: str, max_frames: int = 600, fps: float = 25.0):
    """Split a 'WORD START END ASDSCORE' transcript into <=max_frames segments.

    Returns [text, start, end, duration] rows (retinaface/utils.py:8).
    """
    lines = open(filename).read().splitlines()
    flag = False
    stack: List[str] = []
    res = []
    tmp = 0.0
    start_ts = 0.0
    last_ts = 0.0
    threshold = max_frames / fps
    end = 0.0
    for line in lines:
        if "WORD START END ASDSCORE" in line:
            flag = True
            continue
        if flag:
            word, start, end, _score = line.split(" ")
            start, end = float(start), float(end)
            if end < tmp + threshold:
                stack.append(word)
                last_ts = end
            else:
                res.append([" ".join(stack), start_ts, last_ts, last_ts - start_ts])
                tmp = start
                start_ts = start
                stack = [word]
    if stack:
        res.append([" ".join(stack), start_ts, end, end - start_ts])
    return res
