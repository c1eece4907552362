"""Faults planted in the program's timed path, for the checks of
``correct``: each breaks one stage under the facade, which runs on as
before. The CPU tests run a miniature cell under each
(portbench/tests/test_portbench_faults.py); ``control.py --faults`` reads
them on the card at a cell's own size. Like program.py, this file
imports the port; the benchmark's own runs never load it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(module, name: str, make):
    """``module.name`` replaced by ``make(original)`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def state_unchanged():
    """The tracker step hands back the store it was given."""
    from botsort_tpu_torch.pipeline import frame_step

    def make(original):
        def broken(stores, *args, **kw):
            _, tracks = original(stores, *args, **kw)
            return stores, tracks
        return broken
    return patched(frame_step, "tracker_update_batched", make)


def half_batch():
    """The body encoder leaves out the second half of its batch and fills
    it with the mean of the first half."""
    from botsort_tpu_torch.models.fastreid import FastReIDSBS

    def make(original):
        def broken(self, images):
            out = original(self, images)
            half = max(out.shape[0] // 2, 1)
            return torch.cat([out[:half], out[:half].mean(
                dim=0, keepdim=True).expand(out.shape[0] - half, -1)])
        return broken
    return patched(FastReIDSBS, "forward", make)


def box_altered():
    """Every detection box moved 3 pixels right where NMS produces it."""
    from botsort_tpu_torch.pipeline import frame_step

    def make(original):
        def broken(*args, **kw):
            dets, boxes, valid = original(*args, **kw)
            shift = torch.tensor([3.0, 0.0, 3.0, 0.0], device=boxes.device)
            return dets, boxes + shift, valid
        return broken
    return patched(frame_step, "postprocess_detections_batched", make)


def id_altered():
    """Every track id the tracker outputs is off by one."""
    from botsort_tpu_torch.pipeline import frame_step

    def make(original):
        def broken(*args, **kw):
            stores, tracks = original(*args, **kw)
            return stores, tracks._replace(track_id=tracks.track_id + 1)
        return broken
    return patched(frame_step, "tracker_update_batched", make)


def no_suppression():
    """NMS keeps every candidate of its top-k: the fixpoint suppresses
    nothing."""
    from botsort_tpu_torch.ops import nms

    def make(original):
        def broken(top_boxes, top_valid, iou_threshold):
            return top_valid.clone()
        return broken
    return patched(nms, "nms_fixpoint", make)


def over_suppression():
    """NMS suppresses every second box its fixpoint keeps as well."""
    from botsort_tpu_torch.ops import nms

    def make(original):
        def broken(top_boxes, top_valid, iou_threshold):
            keep = original(top_boxes, top_valid, iou_threshold)
            return keep & (keep.to(torch.int32).cumsum(dim=-1) % 2 == 1)
        return broken
    return patched(nms, "nms_fixpoint", make)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, box_altered,
                                  id_altered, no_suppression,
                                  over_suppression)}
