"""graph.step_runs: CUDA-graph step replays a update over the traced run
(``GraphCache.replays``, a counter of the port's pipeline/graphed.py).
1 is one step a update; above 1, overflow re-runs. None where the
facade replays no graphs."""


def read(rec):
    runs = rec.get("graph_replays")
    if runs is None or rec["updates"] < 1:
        return None
    return runs / rec["updates"]
