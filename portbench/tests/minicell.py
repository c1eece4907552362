"""A miniature cell for the CPU tests: the published classes at miniature
widths, small frames and a short window, written into a temporary copy of
the benchmark's data files, with the registry pointed at it."""

from __future__ import annotations

import argparse
import json
import os
import shutil

from portbench import registry

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MINI_MODELS = {
    "detector": {"program": "botsort_tpu_torch.models.yolox:YOLOX",
                 "reference": "portbench.reference.nets:YOLOX",
                 "args": {"num_classes": 4, "depth": 0.33, "width": 0.25}},
    "body": {"program": "botsort_tpu_torch.models.fastreid:FastReIDSBS",
             "reference": "portbench.reference.nets:FastReIDSBS",
             "args": {"stage_blocks": [1, 1, 1, 1],
                      "stage_widths": [8, 16, 32, 64], "stem_width": 8},
             "float32_norms": ["BatchNorm_0"]},
    "face": {"program": "botsort_tpu_torch.models.facereid:FaceReID",
             "reference": "portbench.reference.nets:FaceReID",
             "args": {"layout": [[1, 8, 1, 1], [6, 16, 1, 2], [6, 32, 1, 2]],
                      "head_width": 64}},
}
MINI_CONFIG = {
    "source": "https://github.com/PINTO0309/BoT-SORT-ONNX-TensorRT",
    "models": MINI_MODELS, "detector_input_hw": [96, 128],
    "body_reid_input_hw": [64, 32], "face_reid_input_hw": [32, 32],
    "dtype": "float32", "crop": "float32", "reduced": [], "assumed": {},
}
MINI_TRAFFIC = {
    "facade": "BoTSORTPipeline", "streams": 1, "loop": "closed",
    "frame_hw": [120, 160], "frame_pool": 4,
    "tracker": {"det_score_threshold": 0.2, "track_high_thresh": 0.15,
                "track_low_thresh": 0.05, "new_track_thresh": 0.2,
                "max_dets": 8, "max_tracks": 16},
    # An IoU threshold at which NMS suppresses: the seeded detector's
    # boxes lie near its anchors and overlap little.
    "nms": {"max_boxes_per_class": 8, "pre_nms_top_k": 64,
            "iou_threshold": 0.05},
    "max_reid_batch": 4, "host_bucket_dispatch": True, "buckets": [0, 4, 8],
    "guard": {}, "warmup_steady": 1, "warmup_max": 3,
    "profile_updates": 2, "sample_updates": 2,
}
LOOSE = {k: 1e9 for k in ("det_gap", "nms_overlap", "nms_uncovered",
                          "nms_count_gap", "hier_mismatch",
                          "body_cos_gap", "face_cos_gap", "track_mismatch",
                          "track_gap")}


def make(tmp_path, monkeypatch, traffic=None, limits=None, streams=1,
         config=None):
    """Write the miniature cell "mini.cell" under tmp_path and point the
    registry there; returns the run's argument namespace. ``config``
    replaces the miniature configuration."""
    root = tmp_path / "checkout"
    here = root / "portbench"
    for kind in ("configs", "traffic", "limits"):
        (here / kind).mkdir(parents=True)
    shutil.copytree(os.path.join(HERE, "metrics"), here / "metrics")
    traffic = dict(MINI_TRAFFIC, **(traffic or {}))
    if streams > 1:
        traffic.update(facade="BatchedBoTSORTPipeline", streams=streams)
    config = config or MINI_CONFIG
    (here / "configs" / "mini.json").write_text(json.dumps(config))
    (here / "traffic" / "mini.json").write_text(json.dumps(traffic))
    (here / "limits" / "mini.cell.json").write_text(
        json.dumps({"limits": limits or LOOSE}))
    bench = registry.benchmark()
    bench["configs"] = [{"name": "mini", "source": config["source"],
                         "file": "portbench/configs/mini.json",
                         "reduced": [], "why": "CPU tests"}]
    bench["workloads"] = [{"name": "mini.cell", "config": "mini",
                           "traffic": "mini", "chips": 1, "why": "CPU tests"}]
    for m in bench["per_layer"]:
        m["workloads"] = ["mini.cell"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "HERE", str(here))
    monkeypatch.setattr(registry, "ROOT", str(root))
    return argparse.Namespace(workload="mini.cell", seed=2 ** 31 + 12345,
                              seconds=1.0, trace=0)
