"""Configuration dataclasses for the tracker, NMS and pipeline.

The port's own copy of botsort_tpu/config.py, so that the port runs
where the JAX package is not installed. Fields, meanings and defaults
are the JAX package's (tests/test_torch_pipeline.py holds them equal).

Every "max_*" field is a fixed slot count: per-frame detections, tracks
and crops live in padded slots with validity masks, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class NMSConfig:
    """Detector post-process. Defaults mirror the reference detector
    ``yolox_x_..._post_1x3x480x640_score015_iou080_box050.onnx``: score
    threshold 0.15, NMS IoU threshold 0.80, at most 50 boxes per class."""

    score_threshold: float = 0.15
    iou_threshold: float = 0.80
    max_boxes_per_class: int = 50
    num_classes: int = 4  # 0=body, 1=head, 2=hand, 3=face
    # Candidates entering the suppression sweep per class. The sweep is
    # exact when at most this many clear the score threshold; beyond that
    # the lowest-scoring overflow is dropped and the class's ``clipped``
    # flag is set.
    pre_nms_top_k: int = 512


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """BoT-SORT association-cascade hyperparameters (the reference's
    tuned settings, demo_bottrack_onnx_tflite.py:1268-1277)."""

    track_high_thresh: float = 0.40   # tracking confidence threshold
    track_low_thresh: float = 0.10    # lowest score valid for tracks
    new_track_thresh: float = 0.90    # new track activation threshold
    match_thresh: float = 0.80        # assignment cost limit, pass 1
    second_match_thresh: float = 0.50  # assignment cost limit, pass 2
    unconfirmed_match_thresh: float = 0.70  # assignment cost limit, pass 3
    track_buffer: int = 300           # frames to keep lost tracks
    feature_history: int = 0          # feature ring depth (0 = no ring)
    proximity_thresh: float = 0.50    # IoU-distance gate for ReID fusion
    appearance_thresh: float = 0.25   # cosine-distance gate for ReID fusion
    frame_rate: int = 30
    feature_ema_alpha: float = 0.90   # smooth-feature EMA
    det_score_threshold: float = 0.35  # detector class score threshold
    max_tracks: int = 64              # tracked + lost + unconfirmed slots
    # Body-detection slots associated and embedded per frame; the tracker's
    # width is min(max_dets, NMSConfig.max_boxes_per_class).
    max_dets: int = 50
    body_feature_dim: int = 2048      # FastReID SBS-S50 embedding
    face_feature_dim: int = 256       # face encoder embedding

    @property
    def buffer_size(self) -> int:
        # demo:1276 — int(frame_rate / 30.0 * track_buffer)
        return int(self.frame_rate / 30.0 * self.track_buffer)

    @property
    def max_time_lost(self) -> int:
        return self.buffer_size


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Model input geometry, ReID batching and host dispatch."""

    detector_input_hw: Tuple[int, int] = (480, 640)
    body_reid_input_hw: Tuple[int, int] = (256, 128)
    face_reid_input_hw: Tuple[int, int] = (128, 128)
    # ReID bucket step: the frame step embeds the body crops at a static
    # bucket from {0, r, 2r, max_dets} (pipeline/frame_step.py).
    max_reid_batch: int = 16
    # Interpolation dtype of every crop and resize of a step (the detector
    # input, the body and face crops; ops/crop.py): "bfloat16" rounds the
    # pixels, weights and x-phase sums to bfloat16, "float32" interpolates
    # in float32. The networks run in the bundle's dtype
    # (runtime/assets.py::build_bundle), as in the JAX package.
    compute_dtype: str = "bfloat16"
    # With a bfloat16 compute_dtype and uint8 frames, the x phase in
    # integers with the weights rounded to q / 127 (the JAX package's
    # int8 crop).
    crop_int8: bool = True
    # Classes emitted in outputs and drawing (0 body, 1 head, 2 hand,
    # 3 face).
    track_target_classes: Tuple[int, ...] = (0, 1, 2, 3)
    # Camera-motion compensation: BoTSORTPipeline estimates an affine per
    # frame on the host (io/gmc.py) and the step applies it to the Kalman
    # states.
    enable_gmc: bool = False
    # Pick the ReID bucket on the host from the previous frame's counts
    # and re-run a frame that overflows it; False embeds every slot.
    host_bucket_dispatch: bool = True
    # IoU-only association: both encoders skipped (bucket 0, zero
    # features make the fused cost plain IoU).
    disable_reid: bool = False
