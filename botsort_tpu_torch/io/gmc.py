"""Host-side camera-motion estimation (port of botsort_tpu/io/gmc.py).

Sparse features and pyramidal Lucas-Kanade between downscaled grayscale
frames, then a robust partial-affine fit: the 2x3 matrix that maps
previous-frame coordinates to current-frame coordinates. It feeds the
device-side state transform ops/kalman.py::apply_affine through the frame
step's ``gmc_affine``. OpenCV is imported when an estimator is built, so
the module imports where OpenCV is not installed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

IDENTITY = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=np.float32)


class GMCEstimator:
    """Estimates the prev->current frame affine motion.

    Every stage is cost-capped, since the estimate runs on the host before
    each frame's step: grayscale conversion on a pixel-strided view (no
    full-resolution conversion, no anti-aliased resize; the stride's
    aliasing costs a fraction of a pixel of fit accuracy, below the
    detector's integer truncation), Lucas-Kanade with a 13x13 window, 2
    pyramid levels and at most 10 iterations, at most ``max_corners``
    corners, RANSAC capped at 300 iterations.
    """

    def __init__(self, downscale: int = 8, max_corners: int = 100):
        import cv2

        self._cv2 = cv2
        self._lk_criteria = (
            cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 10, 0.03)
        self.downscale = downscale
        self.max_corners = max_corners
        self._prev_gray: Optional[np.ndarray] = None
        self._prev_pts: Optional[np.ndarray] = None

    def reset(self):
        self._prev_gray = None
        self._prev_pts = None

    def _to_small_gray(self, frame_bgr: np.ndarray) -> np.ndarray:
        stride = max(1, self.downscale)
        small = frame_bgr[::stride, ::stride]
        return self._cv2.cvtColor(np.ascontiguousarray(small),
                                  self._cv2.COLOR_BGR2GRAY)

    def estimate(self, frame_bgr: np.ndarray) -> np.ndarray:
        """Returns a 2x3 float32 affine mapping previous-frame coordinates
        to current-frame coordinates (identity for the first frame or when
        estimation fails)."""
        cv2 = self._cv2
        gray = self._to_small_gray(frame_bgr)
        h = IDENTITY.copy()
        if self._prev_gray is not None and self._prev_pts is not None \
                and len(self._prev_pts) >= 6:
            nxt, status, _ = cv2.calcOpticalFlowPyrLK(
                self._prev_gray, gray, self._prev_pts, None,
                winSize=(13, 13), maxLevel=2, criteria=self._lk_criteria)
            if nxt is not None:
                ok = status.reshape(-1).astype(bool)
                p0 = self._prev_pts[ok]
                p1 = nxt[ok]
                if len(p0) >= 6:
                    mat, _ = cv2.estimateAffinePartial2D(
                        p0, p1, method=cv2.RANSAC, maxIters=300,
                        confidence=0.98)
                    if mat is not None:
                        mat = mat.astype(np.float32)
                        # Undo the downscale on the translation part.
                        mat[:, 2] *= self.downscale
                        h = mat
        self._prev_gray = gray
        self._prev_pts = cv2.goodFeaturesToTrack(
            gray, maxCorners=self.max_corners, qualityLevel=0.01,
            minDistance=7, blockSize=7)
        return h
