"""Head pose (pitch/yaw/roll) from 68/51/49-point landmarks via EPnP.

The port's copy of ``avsr_tpu/frontends/headpose.py``: a
behavior-compatible re-implementation of the reference HeadPoseEstimator
(reference src/ibug/face_detection/utils/head_pose_estimator.py:11):
solvePnP against a 5-point mean shape derived from the Basel Face Model
landmarks, with the reference's angle-preference disambiguation.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

_ASSET = os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                      "bfm_lms.npy")


def load_bfm_landmarks(path: Optional[str] = None) -> np.ndarray:
    """The Basel Face Model's 68 landmarks: ``path``, else
    ``$AVSR_BFM_LMS``, else ``assets/bfm_lms.npy`` of the repository."""
    for p in (path,) if path else (os.environ.get("AVSR_BFM_LMS", ""), _ASSET):
        if p and os.path.isfile(p):
            return np.load(p)
    raise FileNotFoundError("bfm_lms.npy not found; set AVSR_BFM_LMS")


class HeadPoseEstimator:
    def __init__(self, mean_shape_path: Optional[str] = None):
        mean_shape = load_bfm_landmarks(mean_shape_path)
        left_eye = mean_shape[[37, 38, 40, 41]].mean(axis=0)
        right_eye = mean_shape[[43, 44, 46, 47]].mean(axis=0)
        pts = np.vstack((left_eye, right_eye, mean_shape[[30, 48, 54]]))
        pts[:, 1] = -pts[:, 1]  # flip y to image coordinates
        self._mean_shape_5pts = pts

    def __call__(
        self,
        landmarks: np.ndarray,
        image_width: int = 0,
        image_height: int = 0,
        camera_matrix: Optional[np.ndarray] = None,
        dist_coeffs: Optional[np.ndarray] = None,
        output_preference: int = 0,
    ) -> Tuple[float, float, float]:
        import cv2

        if camera_matrix is None:
            if image_width <= 0 or image_height <= 0:
                raise ValueError("image size required without camera_matrix")
            f = image_width + image_height
            camera_matrix = np.array(
                [[f, 0, image_width / 2.0], [0, f, image_height / 2.0], [0, 0, 1]],
                dtype=float,
            )
        if landmarks.shape[0] == 68:
            landmarks = landmarks[17:]
        if landmarks.shape[0] in (49, 51):
            left_eye = landmarks[[20, 21, 23, 24]].mean(axis=0)
            right_eye = landmarks[[26, 27, 29, 30]].mean(axis=0)
            landmarks = np.vstack((left_eye, right_eye, landmarks[[13, 31, 37]]))

        _, rvec, _ = cv2.solvePnP(
            self._mean_shape_5pts, landmarks[:, None, :], camera_matrix,
            dist_coeffs, flags=cv2.SOLVEPNP_EPNP,
        )
        rot, _ = cv2.Rodrigues(rvec)
        if 1.0 + rot[2, 0] < 1e-9:
            pitch, yaw = 0.0, 90.0
            roll = -math.atan2(rot[0, 1], rot[0, 2]) / math.pi * 180.0
        elif 1.0 - rot[2, 0] < 1e-9:
            pitch, yaw = 0.0, -90.0
            roll = math.atan2(-rot[0, 1], -rot[0, 2]) / math.pi * 180.0
        else:
            pitch = math.atan2(rot[2, 1], rot[2, 2]) / math.pi * 180.0
            yaw = -math.asin(rot[2, 0]) / math.pi * 180.0
            roll = math.atan2(rot[1, 0], rot[0, 0]) / math.pi * 180.0

        if output_preference != 2:
            alt_pitch = pitch - 180.0 if pitch > 0.0 else pitch + 180.0
            alt_yaw = -180.0 - yaw if yaw < 0.0 else 180.0 - yaw
            alt_roll = roll - 180.0 if roll > 0.0 else roll + 180.0
            if (
                output_preference == 1 and -90.0 < alt_pitch < 90.0
                or output_preference == 3 and -90.0 < alt_roll < 90.0
                or output_preference not in (1, 2, 3)
                and abs(alt_pitch) + abs(alt_yaw) + abs(alt_roll)
                < abs(pitch) + abs(yaw) + abs(roll)
            ):
                pitch, yaw, roll = alt_pitch, alt_yaw, alt_roll
        return -pitch, yaw, roll
