"""Runs one cell of BENCHMARK.json once and prints one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as ``setup_s``, from the start of this script): the port's
kernels built or loaded, weights and frames made from the seed on the
card, the facade built and warmed up until its graph cache captures
nothing new, then reset to an empty store. The window: a closed loop of
one client, the next ``update`` as soon as the last returns, for
``--seconds``; every update timed on the host clock from the call to the
return. With ``--trace 1`` the window is followed by a torch.profiler
run over the traffic's ``profile_updates`` further updates, and the line
carries the per-layer metrics and the breakdown instead of the end-to-end
ones. After the window: the peak device memory, the load guard, then the
program is freed and the sampled updates are judged against the plain
reference (portbench/judge.py), the per-layer readers run, and last, with
nothing left to load, the check that no JAX module was loaded.

Exit codes: 0 with a result line; 2 without a card (or fewer than the
cell asks for); 3 when the load guard fails; 4 when a forbidden module
was loaded; 1 on any other error. Only exit 0 prints a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Every kernel and build cache inside the checkout, at fixed paths.
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "portbench", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "portbench", "extensions"))

import numpy as np  # noqa: E402

# Top-level module names a run must not load: the JAX package and JAX,
# and the repository's JAX-side scripts.
FORBIDDEN = ("jax", "jaxlib", "flax", "botsort_tpu", "bench", "chip_smoke",
             "tools")


class Abort(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: ``botsort_tpu_torch`` is not
    ``botsort_tpu``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".")[0] in FORBIDDEN)


def settings_of(cfg, traffic):
    """The pipeline Settings of a configuration and a traffic mix: the
    embedding widths from the configuration's encoders, which the traffic
    may not set too."""
    from portbench import networks
    from portbench.reference.pipeline import Settings

    dims = networks.feature_dims(cfg)
    both = sorted(set(dims) & set(traffic["tracker"]))
    if both:
        raise ValueError(f"the traffic sets {', '.join(both)}, which the "
                         f"configuration's encoders give")
    return Settings(**traffic["tracker"], **dims, **traffic.get("nms", {}),
                    detector_input_hw=tuple(cfg["detector_input_hw"]),
                    body_reid_input_hw=tuple(cfg["body_reid_input_hw"]),
                    face_reid_input_hw=tuple(cfg["face_reid_input_hw"]),
                    crop_mode=cfg["crop"])


class Sampler:
    """A uniform sample, drawn from the seed, of the window's updates
    (reservoir sampling), plus the window's first update, which starts
    from an empty store."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
        self.k = k
        self.first = None
        self.kept = []
        self.seen = 0

    def offer(self, entry):
        if entry["update"] == 0:
            self.first = entry
            return
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(entry)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.kept[j] = entry

    def samples(self):
        out = ([self.first] if self.first is not None else []) + self.kept
        return sorted(out, key=lambda e: e["update"])


def percentile(values, q):
    """The q-th percentile, linear between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def live_counts(res, d: int):
    """(frames, live bodies, attached faces, live bodies per stream, live
    tracks per stream) of a host result dict with a leading stream
    dimension."""
    valid = res["det_valid"][:, 0, :d]
    hb = res["head_for_body"][:, :d]
    ffh = res["face_for_head"]
    faces = 0
    for b in range(valid.shape[0]):
        h = hb[b]
        has = (h >= 0) & (ffh[b][np.clip(h, 0, None)] >= 0) & valid[b]
        faces += int(has.sum())
    return (valid.shape[0], int(valid.sum()), faces, valid.sum(axis=-1),
            res["tracks.valid"].sum(axis=-1))


def batched(res, single: bool):
    return {k: (np.asarray(v)[None] if single else np.asarray(v))
            for k, v in res.items()}


def window_load(results, d: int):
    """(failed updates, [frames, live bodies, attached faces], load) of the
    window's host results (None for an update that raised): the load is
    the fewest and most live bodies a stream and the most live tracks a
    stream over the window."""
    failed = 0
    useful = [0, 0, 0]
    load = {"min_bodies": None, "max_bodies": 0, "max_tracks": 0}
    for res in results:
        if res is None:
            failed += 1
            continue
        failed += update_failed(res)
        n_f, n_b, n_face, bodies, tracks = live_counts(res, d)
        useful[0] += n_f
        useful[1] += n_b
        useful[2] += n_face
        low = int(bodies.min())
        load["min_bodies"] = low if load["min_bodies"] is None else \
            min(load["min_bodies"], low)
        load["max_bodies"] = max(load["max_bodies"], int(bodies.max()))
        load["max_tracks"] = max(load["max_tracks"], int(tracks.max()))
    return failed, useful, load


def update_failed(res) -> bool:
    for k in ("det_boxes", "det_scores", "tracks.tlbr", "tracks.score"):
        if not np.isfinite(res[k]).all():
            return True
    return not bool(np.asarray(res["nms_converged"]).all())


def run(args, device_kind: str = "cuda") -> dict:
    import torch

    from portbench import counts, gen, judge, program, registry, trace

    parts = {"start": T_START, "imports": time.perf_counter()}
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    limits = registry.limits(args.workload)["limits"]
    if device_kind == "cuda":
        if not torch.cuda.is_available():
            raise Abort(2, "no CUDA device: the benchmark runs on the card "
                           "only")
        if torch.cuda.device_count() < cell["chips"]:
            raise Abort(2, f"{cell['chips']} cards asked, "
                           f"{torch.cuda.device_count()} present")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        program.load_kernels()
    # One process, one host thread for PyTorch's own CPU work: the facade
    # does its host work on the calling thread, and idle worker threads
    # only contend with it.
    torch.set_num_threads(1)
    dev = torch.device(device_kind)
    try:
        s = settings_of(cfg, traffic)
    except ValueError as exc:
        raise ValueError(f"configs/{cell['config']}.json and traffic/"
                         f"{cell['traffic']}.json: {exc}") from None
    if traffic["loop"] != "closed":
        raise ValueError(f"traffic loop {traffic['loop']!r}: only the closed "
                         "loop is measured")
    single = traffic["facade"] == "BoTSORTPipeline"
    streams = traffic["streams"]

    # Set-up: frames and weights from the seed, the facade, its warm-up.
    parts["kernels"] = time.perf_counter()
    pool = gen.frame_pool(args.seed, traffic["frame_pool"], streams,
                          tuple(traffic["frame_hw"]), dev)
    parts["frames"] = time.perf_counter()
    ref_nets = gen.reference_networks(cfg, args.seed, dev,
                                      torch.from_numpy(pool[0, 0]).to(dev), s)
    bundle = program.bundle([m.state_dict() for m in ref_nets], cfg,
                            cfg["dtype"], dev)
    del ref_nets
    parts["weights"] = time.perf_counter()
    frames_of = (lambda u: pool[u % len(pool), 0]) if single else \
        (lambda u: pool[u % len(pool)])
    pipe = program.facade(bundle, s, traffic, cfg)
    cache = program.graph_cache(pipe)
    steady, u = 0, 0
    while steady < traffic["warmup_steady"] and u < traffic["warmup_max"]:
        before = cache.captures if cache is not None else 0
        pipe.update(frames_of(u))
        u += 1
        steady = steady + 1 if cache is None or \
            cache.captures == before else 0
    pipe.reset()
    if device_kind == "cuda":
        torch.cuda.synchronize()
    parts["warmup"] = time.perf_counter()
    counted, undo = (program.step_counter() if args.trace
                     else ({}, lambda: None))
    replays0 = cache.replays if cache is not None else None

    # The window: the update and a reference to what it returned; the
    # counting is done once the window has closed. The sampler only keeps
    # references too.
    sampler = Sampler(args.seed, traffic["sample_updates"])
    latencies, results, attempted = [], [], 0
    setup_s = time.perf_counter() - T_START
    t0 = time.perf_counter()
    while True:
        pre = program.store(pipe)
        ta = time.perf_counter()
        try:
            pipe.update(frames_of(attempted))
            res = pipe.last_result
        except Exception as exc:  # a boundary: count it, keep measuring
            print(f"update {attempted} raised {exc!r}", file=sys.stderr)
            res = None
        tb = time.perf_counter()
        latencies.append(tb - ta)
        results.append(res)
        if res is not None:
            sampler.offer({"update": attempted, "pre": pre,
                           "post": program.store(pipe)})
        attempted += 1
        if tb - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    updates = attempted
    results = [None if r is None else batched(program.as_dict(r), single)
               for r in results]
    failed, useful, load = window_load(results, s.det_width)
    cell_counts = counts.cell_counts(cfg)
    record = {"timers": pipe.timers.report(), "unprofiled_seconds": window_s,
              "unprofiled_flops": counts.useful_flops(cell_counts, *useful),
              "updates": updates}

    replays = cache.replays - replays0 if cache is not None else None
    record["graph_replays"] = replays

    if args.trace:
        n_prof = traffic["profile_updates"]
        marks = {}

        def one():
            nonlocal attempted
            with torch.profiler.record_function(trace.SPANS[0]):
                pipe.update(frames_of(attempted))
            attempted += 1
            if not marks:  # the unrecorded first call has returned
                marks.update(counted)

        unspan = program.spans()
        try:
            events, window = trace.profile(one, n_prof)
        finally:
            unspan()
        norm_bytes = 0.0
        for key, n in counted.items():
            kind, b, t, h, w, rb, fb, _ = key
            norm_bytes += (n - marks.get(key, 0)) * counts.run_norm_bytes(
                cell_counts, b * t, b * t * rb, b * t * fb)
        record.update({
            "events": events, "window": window, "profiled_updates": n_prof,
            "streams": streams, "norm_bytes_profiled": norm_bytes})
        undo()

    device = {"platform": "gpu" if device_kind == "cuda" else device_kind,
              "kind": (torch.cuda.get_device_name(0)
                       if device_kind == "cuda" else device_kind),
              "count": cell["chips"],
              "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                    if device_kind == "cuda" else 0)}
    if args.trace:
        device["busy_s"] = trace.busy_us(record["events"]) / 1e6
        device["window_s"] = (record["window"][1] - record["window"][0]) / 1e6

    # The load guard.
    guard = traffic["guard"]
    least = guard.get("min_live_bodies", 0)
    if load["min_bodies"] is None or load["min_bodies"] < least:
        raise Abort(3, f"load guard: {load['min_bodies']} live bodies in an "
                       f"update, fewer than {least}")
    for key, most in (("max_live_bodies", "max_bodies"),
                      ("max_live_tracks", "max_tracks")):
        if key in guard and load[most] > guard[key]:
            raise Abort(3, f"load guard: {load[most]} ({most}) in a stream, "
                           f"more than {guard[key]}")

    # Free the program, then judge the sample against the reference, whose
    # networks are made again from the seed.
    samples = sampler.samples()
    for smp in samples:
        smp["pre"] = judge.as_store(smp["pre"], dev, not single)
        smp["post"] = judge.as_store(smp["post"], dev, not single)
        smp["res"] = results[smp["update"]]
    del pipe, bundle, cache, results
    gc.collect()
    if device_kind == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    networks = gen.reference_networks(cfg, args.seed, dev,
                                      torch.from_numpy(pool[0, 0]).to(dev), s)
    readings = []
    with torch.no_grad():
        for smp in samples:
            frames = torch.from_numpy(pool[smp["update"] % len(pool)]).to(dev)
            readings.append(judge.judge_sample(
                networks, frames, smp["pre"],
                judge.as_result(smp["res"], dev, True), smp["post"], s))
    combined = judge.combine(readings)
    rows, ok = judge.checks(combined, limits, failed)
    check_s = time.perf_counter() - t_check

    if args.trace:
        rec = dict(record)
        metrics = {}
        for m in registry.cell_metrics(bench, args.workload, "per_layer"):
            value = registry.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        lat_ms = [x * 1e3 for x in latencies]
        e2e = {"frames_per_s": updates * streams / window_s,
               "update_ms_p50": percentile(lat_ms, 50),
               "update_ms_p95": percentile(lat_ms, 95),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in registry.cell_metrics(bench, args.workload,
                                                  "end_to_end")}
    out = {"correct": bool(ok and failed == 0), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device}
    if args.trace:
        out["breakdown"] = {
            "device_ops": trace.device_ops(record["events"]),
            "idle_gaps": trace.idle_gaps(record["events"],
                                         record["window"])}
    marks = list(parts.items()) + [("window", T_START + setup_s)]
    out["info"] = {"samples": [smp["update"] for smp in samples],
                   "check_s": check_s, "updates_in_window": updates,
                   "setup_parts_s": {name: marks[i][1] - marks[i - 1][1]
                                     for i, (name, _) in enumerate(marks)
                                     if i},
                   "judge": judge.info(readings),
                   "load": dict(load,
                                mean_bodies=useful[1] / max(useful[0], 1),
                                mean_faces=useful[2] / max(useful[0], 1)),
                   "graph_replays": record["graph_replays"],
                   "stages_ms": record["timers"],
                   "latency_ms": {
                       f"p{q}": percentile(latencies, q) * 1e3
                       for q in (5, 25, 75, 99, 100)}}
    out["checks"] = {name: {"value": value, "limit": lim}
                     for name, value, lim in rows}
    # Last, once nothing more is loaded: no JAX, no JAX package.
    found = forbidden_modules()
    if found:
        raise Abort(4, f"forbidden modules loaded: {found}")
    for name, value, lim in rows:
        print(f"check: {name} {value} limit {lim}", file=sys.stderr)
    return out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device_kind: str = "cuda") -> int:
    args = parse(argv)
    try:
        out = run(args, device_kind)
    except Abort as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return exc.code
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
