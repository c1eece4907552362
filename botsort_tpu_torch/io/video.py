"""Video capture and writer for the demo (port of botsort_tpu/io/video.py).

OpenCV decodes on a background thread into a bounded queue, so the
tracking loop does not wait on ``cv2.VideoCapture.read``. Only the demo
imports this module; the tracker's main path needs no OpenCV.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import cv2
import numpy as np


def open_capture(source: str) -> cv2.VideoCapture:
    """Camera index or file path."""
    try:
        return cv2.VideoCapture(int(source))
    except ValueError:
        return cv2.VideoCapture(source)


class PrefetchingCapture:
    """Background-decodes frames into a bounded queue."""

    def __init__(self, source: str, depth: int = 4):
        self.cap = open_capture(source)
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(depth)
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._stopped = threading.Event()
        self._thread.start()

    @property
    def fps(self) -> float:
        return self.cap.get(cv2.CAP_PROP_FPS) or 30.0

    @property
    def frame_size(self) -> Tuple[int, int]:
        return (
            int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        )

    def _pump(self):
        while not self._stopped.is_set():
            ok, frame = self.cap.read()
            if not ok:
                self._q.put(None)
                return
            self._q.put(frame)

    def frames(self) -> Iterator[np.ndarray]:
        while True:
            frame = self._q.get()
            if frame is None:
                return
            yield frame

    def release(self):
        self._stopped.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self.cap.release()


def make_writer(path: str, fps: float,
                frame_size: Tuple[int, int]) -> cv2.VideoWriter:
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    return cv2.VideoWriter(path, fourcc, fps, frame_size)
