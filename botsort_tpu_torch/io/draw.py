"""Frame annotation (port of botsort_tpu/io/draw.py): boxes, ids, dashed
face rects, mosaic, latency text.

Mirrors the reference's drawing (demo_bottrack_onnx_tflite.py:1852-1894,
2129-2185): white-under-color double rectangles, per-class colors, dashed
rectangles for faces, optional pixelation mosaic (2x2 down-up resize),
and a white/red latency overlay.
"""

from __future__ import annotations

from typing import List, Tuple

import cv2

from botsort_tpu_torch.pipeline.boxes import Box
from botsort_tpu_torch.pipeline.host import STrackView


def class_color(classid: int) -> Tuple[int, int, int]:
    # demo:1852-1862 (BGR).
    return {
        0: (255, 0, 0),
        1: (0, 255, 0),
        2: (0, 0, 255),
        3: (0, 233, 245),
    }.get(classid, (255, 255, 255))


def draw_dashed_line(img, pt1, pt2, color, thickness=1, dash=10):
    dist = ((pt1[0] - pt2[0]) ** 2 + (pt1[1] - pt2[1]) ** 2) ** 0.5
    n = max(int(dist / dash), 1)
    for i in range(n):
        s = (int(pt1[0] + (pt2[0] - pt1[0]) * i / n),
             int(pt1[1] + (pt2[1] - pt1[1]) * i / n))
        e = (int(pt1[0] + (pt2[0] - pt1[0]) * (i + 0.5) / n),
             int(pt1[1] + (pt2[1] - pt1[1]) * (i + 0.5) / n))
        cv2.line(img, s, e, color, thickness)


def draw_dashed_rect(img, tl, br, color, thickness=1, dash=10):
    tr = (br[0], tl[1])
    bl = (tl[0], br[1])
    draw_dashed_line(img, tl, tr, color, thickness, dash)
    draw_dashed_line(img, tr, br, color, thickness, dash)
    draw_dashed_line(img, br, bl, color, thickness, dash)
    draw_dashed_line(img, bl, tl, color, thickness, dash)


def _label(img, text, x, y, width):
    ptx = x if x + 50 < width else width - 50
    pty = y - 10 if y - 25 > 0 else 20
    cv2.putText(img, text, (ptx, pty), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                (255, 255, 255), 2, cv2.LINE_AA)
    cv2.putText(img, text, (ptx, pty), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                (0, 0, 255), 1, cv2.LINE_AA)


def _double_rect(img, box: Box):
    color = class_color(box.classid)
    cv2.rectangle(img, (box.x1, box.y1), (box.x2, box.y2),
                  (255, 255, 255), 2)
    cv2.rectangle(img, (box.x1, box.y1), (box.x2, box.y2), color, 1)


def mosaic(img, box: Box):
    # demo:2157-2161: downscale the face region to 2x2 and back.
    w = abs(box.x2 - box.x1)
    h = abs(box.y2 - box.y1)
    if w < 2 or h < 2:
        return
    region = img[box.y1:box.y2, box.x1:box.x2]
    img[box.y1:box.y2, box.x1:box.x2] = cv2.resize(
        cv2.resize(region, (2, 2)), (w, h))


def draw_latency(img, seconds: float):
    text = f"{seconds * 1000:.2f} ms"
    cv2.putText(img, text, (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                (255, 255, 255), 2, cv2.LINE_AA)
    cv2.putText(img, text, (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                (0, 0, 255), 1, cv2.LINE_AA)


def draw_tracks(img, tracks: List[STrackView], face_mosaic: bool = False):
    width = img.shape[1]
    for t in tracks:
        x1, y1, x2, y2 = (int(v) for v in t.tlbr)
        cv2.rectangle(img, (x1, y1), (x2, y2), (255, 255, 255), 2)
        cv2.rectangle(img, (x1, y1), (x2, y2), (255, 0, 0), 1)
        _label(img, str(t.track_id), x1, y1, width)

        body = t.body
        if body is None:
            continue
        if body.head is not None:
            _double_rect(img, body.head)
            _label(img, str(body.head.trackid), body.head.x1,
                   body.head.y1, width)
            face = body.head.face
            if face is not None:
                if face_mosaic:
                    mosaic(img, face)
                color = class_color(face.classid)
                draw_dashed_rect(img, (face.x1, face.y1),
                                 (face.x2, face.y2), (255, 255, 255), 2, 5)
                draw_dashed_rect(img, (face.x1, face.y1),
                                 (face.x2, face.y2), color, 1, 5)
                _label(img, str(face.trackid), face.x1, face.y1, width)
        for hand in (body.hand1, body.hand2):
            if hand is not None:
                _double_rect(img, hand)
                _label(img, str(hand.trackid), hand.x1, hand.y1, width)
