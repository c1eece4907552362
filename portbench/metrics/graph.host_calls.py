"""graph.host_calls: host calls that launch device work (kernel launches,
graph launches, async copies and sets) a update, counted in the profiled
updates' torch.profiler events."""

from portbench import trace


def read(rec):
    if rec["profiled_updates"] < 1:
        return None
    return trace.host_calls(rec["events"]) / rec["profiled_updates"]
