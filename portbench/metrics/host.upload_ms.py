"""host.upload_ms: mean host-clock ms a update of the facade's "upload"
stage (``StageTimers`` in the port's pipeline/host.py: the frames copied
into the pinned staging buffer and the copy to the card enqueued), over
the traced run's unprofiled updates."""


def read(rec):
    return rec["timers"].get("upload")
