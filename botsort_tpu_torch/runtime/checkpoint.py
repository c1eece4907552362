"""Tracker-state checkpoint and resume (port of
botsort_tpu/runtime/checkpoint.py).

A live tracking session is its TrackStore: track ids, Kalman states,
appearance features and the frame counter. ``save_store`` writes it with
``torch.save`` as a dict of CPU tensors, one per present field (the absent
feature-history fields are skipped); ``load_store`` reads it back onto a
device, so that a stream can move to another process or card and go on
exactly where it stopped. The JAX package writes orbax checkpoints; the
port uses torch's own format. ``host`` integers saved beside the store
(the facades' frame count and bucket hint: pipeline/host.py
``save_session``) come back from ``load_checkpoint``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch

from botsort_tpu_torch.track.state import TrackStore


_HOST = "host."


def save_store(path: str, store: TrackStore, **host: Optional[int]) -> None:
    """Write ``store`` (one stream's, or B streams' with a leading [B]) to
    ``path``, with the ``host`` integers that are not None; the copy to the
    host is the only wait for the card."""
    payload = {f.name: getattr(store, f.name).detach().cpu()
               for f in dataclasses.fields(store)
               if getattr(store, f.name) is not None}
    payload.update({_HOST + k: torch.tensor(v, dtype=torch.int64)
                    for k, v in host.items() if v is not None})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cpu"
                    ) -> Optional[Tuple[TrackStore, Dict[str, int]]]:
    """(the TrackStore saved at ``path`` on ``device``, the ``host``
    integers saved with it), or None where no checkpoint exists."""
    if not os.path.isfile(path):
        return None
    payload = torch.load(path, map_location="cpu", weights_only=True)
    store = TrackStore(**{
        f.name: (payload[f.name].to(device) if f.name in payload else None)
        for f in dataclasses.fields(TrackStore)})
    host = {k[len(_HOST):]: int(v) for k, v in payload.items()
            if k.startswith(_HOST)}
    return store, host


def load_store(path: str, device="cpu") -> Optional[TrackStore]:
    """The TrackStore saved at ``path`` on ``device``, or None where no
    checkpoint exists."""
    saved = load_checkpoint(path, device)
    return None if saved is None else saved[0]
