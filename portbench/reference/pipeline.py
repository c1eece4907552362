"""One tracker step in plain PyTorch, stage by stage.

The stages of the port's frame step (``pipeline/frame_step.py``), rebuilt
from the plain pieces beside this file: the detector input resize, the
detector and its decode, class-aware NMS, the rescale to source pixels
and the score filter (``detect``); the box hierarchy (``hierarchy``); the
body and face crops and their embeddings, every detection slot at once
with no bucket (``embed``); the tracker (``tracker.tracker_update_batched``).
``step`` chains them; the benchmark's judge calls them one at a time on
the program's own outputs (portbench/judge.py). Everything has a leading
stream dimension B.

``Settings`` holds every number a step reads. The benchmark fills it from
its traffic file and hands the same numbers to the program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from portbench.reference import nets, ops, tracker

BODIES, HEADS, HANDS, FACES = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Settings:
    # Detector post-process.
    score_threshold: float = 0.15
    iou_threshold: float = 0.80
    max_boxes_per_class: int = 50
    pre_nms_top_k: int = 512
    # Tracker.
    track_high_thresh: float = 0.40
    track_low_thresh: float = 0.10
    new_track_thresh: float = 0.90
    match_thresh: float = 0.80
    second_match_thresh: float = 0.50
    unconfirmed_match_thresh: float = 0.70
    track_buffer: int = 300
    feature_history: int = 0
    proximity_thresh: float = 0.50
    appearance_thresh: float = 0.25
    frame_rate: int = 30
    feature_ema_alpha: float = 0.90
    det_score_threshold: float = 0.35
    max_tracks: int = 64
    max_dets: int = 50
    body_feature_dim: int = 2048
    face_feature_dim: int = 256
    # Geometry and crop numerics.
    detector_input_hw: Tuple[int, int] = (480, 640)
    body_reid_input_hw: Tuple[int, int] = (256, 128)
    face_reid_input_hw: Tuple[int, int] = (128, 128)
    crop_mode: str = "int8"

    @property
    def max_time_lost(self) -> int:
        return int(self.frame_rate / 30.0 * self.track_buffer)

    @property
    def det_width(self) -> int:
        return min(self.max_dets, self.max_boxes_per_class)


def _rescale_to_source(boxes, in_hw, src_hw):
    in_h, in_w = in_hw
    src_h, src_w = src_hw
    x1 = torch.floor(torch.clamp(boxes[..., 0], min=0.0) * (src_w / in_w))
    y1 = torch.floor(torch.clamp(boxes[..., 1], min=0.0) * (src_h / in_h))
    x2 = torch.floor(torch.clamp(boxes[..., 2], max=in_w) * (src_w / in_w))
    y2 = torch.floor(torch.clamp(boxes[..., 3], max=in_h) * (src_h / in_h))
    return torch.stack([x1, y1, x2, y2], dim=-1)


def detect(detector, frames: torch.Tensor, s: Settings
           ) -> Dict[str, torch.Tensor]:
    """frames [B, H, W, 3] uint8 -> det_boxes [B, C, K, 4] (source pixels),
    det_scores [B, C, K], det_valid [B, C, K] (NMS survivor above the
    detector's score threshold), nms_valid [B, C, K] (NMS survivor), and
    every anchor's candidate before NMS: cand_boxes [B, A, 4] (source
    pixels), cand_boxes_in [B, A, 4] (the detector's input pixels, as NMS
    compares them) and cand_scores [B, A, C]."""
    b, h, w = frames.shape[:3]
    full = torch.tensor([0.0, 0.0, float(w), float(h)],
                        device=frames.device).expand(b, 1, 4)
    det_in = ops.crop_resize_plain(frames, full, s.detector_input_hw,
                                   s.crop_mode)[:, 0]
    cand_boxes, cand_scores = detector(det_in)
    dets = ops.multiclass_nms_dense_batched(
        cand_boxes.float(), cand_scores.float(), s.iou_threshold,
        s.score_threshold, s.max_boxes_per_class, s.pre_nms_top_k)
    boxes = _rescale_to_source(dets.boxes, s.detector_input_hw, (h, w))
    return {"det_boxes": boxes, "det_scores": dets.scores,
            "det_valid": dets.valid & (dets.scores > s.det_score_threshold),
            "nms_valid": dets.valid,
            "cand_boxes": _rescale_to_source(cand_boxes.float(),
                                             s.detector_input_hw, (h, w)),
            "cand_boxes_in": cand_boxes.float(),
            "cand_scores": cand_scores.float()}


def hierarchy(det_boxes: torch.Tensor, det_valid: torch.Tensor):
    """(face_for_head, head_for_body, hand1_for_body, hand2_for_body), each
    [B, K] int32, for det_boxes [B, C, K, 4]."""
    problems = []
    for b in range(det_boxes.shape[0]):
        boxes, valid = det_boxes[b], det_valid[b]
        problems += [
            (boxes[HEADS], valid[HEADS], boxes[FACES], valid[FACES], 1),
            (boxes[BODIES], valid[BODIES], boxes[HEADS], valid[HEADS], 1),
            (boxes[BODIES], valid[BODIES], boxes[HANDS], valid[HANDS], 2),
        ]
    res = ops.greedy_assign_batch(problems)
    return tuple(torch.stack(picks) for picks in (
        [r[0] for r in res[0::3]], [r[0] for r in res[1::3]],
        [r[0] for r in res[2::3]], [r[1] for r in res[2::3]]))


def _encode(encoder, prep, frames, tlbr, hw, s: Settings, chunk: int):
    """encoder(prep(crops)) of the boxes tlbr [B, D, 4], ``chunk`` crops a
    call -> [B, D, dim] float32."""
    crops = ops.crop_resize_plain(frames, tlbr, hw, s.crop_mode)
    flat = crops.flatten(0, 1)
    out = torch.cat([encoder(prep(flat[i:i + chunk]))
                     for i in range(0, flat.shape[0], chunk)])
    return out.float().reshape(tlbr.shape[0], tlbr.shape[1], -1)


def face_boxes(det_boxes, face_for_head, head_for_body, d: int):
    """Per body slot (first d) its head's face box, or the all-zero box
    (whose crop is all zeros) where it has none: [B, d, 4]."""
    hb = head_for_body[:, :d].long()
    fb = torch.where(hb >= 0, torch.gather(face_for_head.long(), 1,
                                           hb.clamp(min=0)), -1)
    faces = torch.gather(det_boxes[:, FACES], 1,
                         fb.clamp(min=0)[..., None].expand(-1, -1, 4))
    return torch.where((fb >= 0)[..., None], faces, 0.0)


def embed(body_encoder, face_encoder, frames, det_boxes, face_for_head,
          head_for_body, s: Settings, chunk: int = 64):
    """(body_feats [B, d, Db], face_feats [B, d, Df]) of every one of the
    first d body slots."""
    d = s.det_width
    body = _encode(body_encoder, nets.preprocess, frames,
                   det_boxes[:, BODIES, :d], s.body_reid_input_hw, s, chunk)
    face = _encode(face_encoder, lambda x: x, frames,
                   face_boxes(det_boxes, face_for_head, head_for_body, d),
                   s.face_reid_input_hw, s, chunk)
    return body, face


def track(store, dets: Dict[str, torch.Tensor], body_feats, face_feats,
          s: Settings):
    d = s.det_width
    return tracker.tracker_update_batched(
        store, dets["det_boxes"][:, BODIES, :d],
        dets["det_scores"][:, BODIES, :d], dets["det_valid"][:, BODIES, :d],
        body_feats, face_feats, s)


def step(networks, store, frames: torch.Tensor, s: Settings):
    """One whole step from the frames: (new store, outputs: the detections,
    the hierarchy and the tracks, as the program's FrameResult names
    them)."""
    detector, body_encoder, face_encoder = networks
    dets = detect(detector, frames, s)
    ffh, hfb, h1, h2 = hierarchy(dets["det_boxes"], dets["det_valid"])
    body, face = embed(body_encoder, face_encoder, frames, dets["det_boxes"],
                       ffh, hfb, s)
    new_store, tracks = track(store, dets, body, face, s)
    out = {k: v for k, v in dets.items() if not k.startswith("cand_")}
    out.update(face_for_head=ffh, head_for_body=hfb,
               hand1_for_body=h1, hand2_for_body=h2)
    out.update({f"tracks.{k}": v for k, v in tracks._asdict().items()})
    return new_store, out
