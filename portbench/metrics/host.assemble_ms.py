"""host.assemble_ms: mean host-clock ms a update of the facade's
"assemble" stage (``StageTimers``: the host track lists built from the
read-back FrameResult), over the traced run's unprofiled updates."""


def read(rec):
    return rec["timers"].get("assemble")
