"""Mouth-ROI extraction: landmarks -> smoothed affine warp -> 96x96 crops.

The port's copy of ``avsr_tpu/frontends/video_process.py``, a
behavior-compatible re-implementation of the reference VideoProcess
(reference src/retinaface/video_process.py:55): linear interpolation of
missing landmarks, 12-frame smoothing window, similarity transform to the
20-words mean face over stable points (28,33,36,39,42,45,48,54), and a
96x96 crop around the mouth landmarks (48-68). Warping is cv2-based and
vectorized where possible; landmark smoothing runs as one numpy pass.
``LandmarksDetector`` sends each batch of frames to the detector's network
in one upload, and each frame's faces to FAN in one more.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

STABLE_POINTS = (28, 33, 36, 39, 42, 45, 48, 54)

_ASSET = os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                      "20words_mean_face.npy")


def load_mean_face(path: Optional[str] = None) -> np.ndarray:
    """The 20-words mean face: ``path``, else ``$AVSR_MEAN_FACE``, else
    ``assets/20words_mean_face.npy`` of the repository."""
    candidates = (path,) if path else (os.environ.get("AVSR_MEAN_FACE", ""),
                                       _ASSET)
    for p in candidates:
        if p and os.path.isfile(p):
            return np.load(p)
    raise FileNotFoundError(
        "20words_mean_face.npy not found; set AVSR_MEAN_FACE or pass a path"
    )


def interpolate_landmarks(landmarks: List[Optional[np.ndarray]]):
    """Fill missing per-frame landmarks by linear interpolation + edge holds."""
    landmarks = list(landmarks)
    valid = [i for i, lm in enumerate(landmarks) if lm is not None]
    if not valid:
        return None
    for a, b in zip(valid[:-1], valid[1:]):
        if b - a > 1:
            delta = landmarks[b] - landmarks[a]
            for k in range(1, b - a):
                landmarks[a + k] = landmarks[a] + (k / float(b - a)) * delta
    for i in range(valid[0]):
        landmarks[i] = landmarks[valid[0]]
    for i in range(valid[-1] + 1, len(landmarks)):
        landmarks[i] = landmarks[valid[-1]]
    return landmarks


def smooth_landmarks(landmarks: np.ndarray, window_margin: int = 12) -> np.ndarray:
    """Per-frame windowed mean, re-centered on the frame's own centroid."""
    t = len(landmarks)
    out = np.empty_like(landmarks)
    for i in range(t):
        m = min(window_margin // 2, i, t - 1 - i)
        win = landmarks[i - m : i + m + 1].mean(axis=0)
        out[i] = win + landmarks[i].mean(axis=0) - win.mean(axis=0)
    return out


class VideoProcess:
    def __init__(
        self,
        mean_face_path: Optional[str] = None,
        crop_width: int = 96,
        crop_height: int = 96,
        start_idx: int = 48,
        stop_idx: int = 68,
        window_margin: int = 12,
        convert_gray: bool = True,
        target_size=(256, 256),
    ):
        self.reference = load_mean_face(mean_face_path)
        self.crop_width = crop_width
        self.crop_height = crop_height
        self.start_idx = start_idx
        self.stop_idx = stop_idx
        self.window_margin = window_margin
        self.convert_gray = convert_gray
        self.target_size = target_size
        ref = self.reference[list(STABLE_POINTS)].astype(np.float32).copy()
        # reference grid is 256x256; shift by (ref - target)/2
        ref[:, 0] -= (256 - target_size[0]) / 2.0
        ref[:, 1] -= (256 - target_size[1]) / 2.0
        self.stable_reference = ref

    def __call__(self, video: np.ndarray, landmarks) -> Optional[np.ndarray]:
        """video (T, H, W, 3) RGB; landmarks list of (68,2) or None per frame.

        Returns (T, 96, 96) grayscale mouth crops, or None if undetectable.
        """
        lms = interpolate_landmarks(landmarks)
        if lms is None or len(lms) < self.window_margin:
            return None
        lms = smooth_landmarks(np.stack(lms), self.window_margin)
        return self.crop_patch(video, lms)

    def crop_patch(self, video: np.ndarray, landmarks: np.ndarray) -> np.ndarray:
        import cv2

        out = []
        for frame, lm in zip(video, landmarks):
            if self.convert_gray:
                frame = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
            transform, _ = cv2.estimateAffinePartial2D(
                lm[list(STABLE_POINTS)].astype(np.float32),
                self.stable_reference,
                method=cv2.LMEDS,
            ), None
            transform = transform[0] if isinstance(transform, tuple) else transform
            warped = cv2.warpAffine(
                frame, transform, dsize=self.target_size,
                flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                borderValue=0,
            )
            warped_lm = lm @ transform[:, :2].T + transform[:, 2]
            out.append(
                self.cut_patch(
                    warped, warped_lm[self.start_idx : self.stop_idx],
                    self.crop_height // 2, self.crop_width // 2,
                )
            )
        return np.stack(out)

    @staticmethod
    def cut_patch(img, landmarks, half_h, half_w, threshold=5):
        cx, cy = np.mean(landmarks, axis=0)
        if abs(cy - img.shape[0] / 2) > half_h + threshold:
            raise OverflowError("too much bias in height")
        if abs(cx - img.shape[1] / 2) > half_w + threshold:
            raise OverflowError("too much bias in width")
        y0 = int(round(np.clip(cy - half_h, 0, img.shape[0])))
        y1 = int(round(np.clip(cy + half_h, 0, img.shape[0])))
        x0 = int(round(np.clip(cx - half_w, 0, img.shape[1])))
        x1 = int(round(np.clip(cx + half_w, 0, img.shape[1])))
        return np.copy(img[y0:y1, x0:x1])


class LandmarksDetector:
    """RetinaFace + FAN pipeline: frames -> largest-face 68-pt landmarks.

    Equivalent of the reference LandmarksDetector (retinaface/detector.py:16),
    but detection batches frames through the networks on the card instead
    of looping.
    """

    def __init__(self, face_detector, landmark_detector, batch_size: int = 16):
        self.face_detector = face_detector
        self.landmark_detector = landmark_detector
        self.batch_size = batch_size

    def __call__(self, video_frames_bgr: np.ndarray) -> List[Optional[np.ndarray]]:
        landmarks: List[Optional[np.ndarray]] = []
        for lo in range(0, len(video_frames_bgr), self.batch_size):
            chunk = np.asarray(video_frames_bgr[lo : lo + self.batch_size])
            detections = self.face_detector.detect_batch(chunk)
            for frame_bgr, dets in zip(chunk, detections):
                if len(dets) == 0:
                    landmarks.append(None)
                    continue
                points, _scores = self.landmark_detector(
                    frame_bgr, dets[:, :4], rgb=False
                )
                sizes = (dets[:, 2] - dets[:, 0]) + (dets[:, 3] - dets[:, 1])
                landmarks.append(points[int(np.argmax(sizes))])
        return landmarks
