"""Host-side box hierarchy objects (port of botsort_tpu/pipeline/boxes.py).

The reference's Box/Body/Head/Face/Hand classes
(demo_bottrack_onnx_tflite.py:84-116): a Body owns an optional Head and
two optional Hands; a Head owns an optional Face. Plain host dataclasses,
assembled from the FrameResult after readback.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Box:
    trackid: int
    classid: int
    score: float
    x1: int
    y1: int
    x2: int
    y2: int
    cx: int
    cy: int
    is_used: bool = False


@dataclasses.dataclass
class Face(Box):
    pass


@dataclasses.dataclass
class Hand(Box):
    pass


@dataclasses.dataclass
class Head(Box):
    face: Optional[Face] = None


@dataclasses.dataclass
class Body(Box):
    head: Optional[Head] = None
    hand1: Optional[Hand] = None
    hand2: Optional[Hand] = None


def make_box(cls, classid: int, score: float, tlbr, trackid: int = 0,
             **extra):
    x1, y1, x2, y2 = (int(v) for v in tlbr)
    # True geometric centers (the reference divides cx and cy apart).
    return cls(trackid=trackid, classid=classid, score=float(score),
               x1=x1, y1=y1, x2=x2, y2=y2,
               cx=(x1 + x2) // 2, cy=(y1 + y2) // 2, **extra)
