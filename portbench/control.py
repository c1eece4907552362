"""Readings for the output limits: the program's over many seeds, and the
control's.

The control is the plain reference put in the program's place with its
networks in float8 e4m3 (the precision below the configurations'
bfloat16): it tracks the cell's own frames at the cell's own sizes from an
empty store, and the same sample of its updates goes through the same
judge (portbench/judge.py) against the float32 reference. A limit lies
above every sound run's reading and below the control's, which must fail
at least one of the cell's numbers.

    python3 -m portbench.control --workload <cell> \
        [--program-seeds 1,2,3 --seconds 5] [--control-seeds 4,5,6 \
        --control-updates 24] [--faults no_suppression,over_suppression \
        --fault-seeds 7,8,9] [--out readings.jsonl]

``--faults`` runs the program with each named fault of faults.py
planted, on each of ``--fault-seeds``, as ``--program-seeds`` runs it.
One JSON line a seed: {"side", "seed", "readings", ...}. On the card
only; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import faults, gen, judge, registry, run  # noqa: E402
from portbench.reference import pipeline  # noqa: E402


def control_readings(workload: str, seed: int, updates: int,
                     device="cuda", precision: str = "fp8"):
    """The judge's readings of the reference run at ``precision`` in the
    program's place over ``updates`` updates of the cell's traffic."""
    bench = registry.benchmark()
    cell = registry.workload(bench, workload)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    s = run.settings_of(cfg, traffic)
    dev = torch.device(device)
    streams = traffic["streams"]
    pool = gen.frame_pool(seed, traffic["frame_pool"], streams,
                          tuple(traffic["frame_hw"]), dev)
    frame0 = torch.from_numpy(pool[0, 0]).to(dev)
    nets_low = gen.reference_networks(cfg, seed, dev, frame0, s, precision)
    store = pipeline.tracker.empty_stores(s, streams, dev)
    sampler = run.Sampler(seed, traffic["sample_updates"])
    t0 = time.perf_counter()
    with torch.no_grad():
        for u in range(updates):
            frames = torch.from_numpy(pool[u % len(pool)]).to(dev)
            new, out = pipeline.step(nets_low, store, frames, s)
            res = {k: v.cpu().numpy() for k, v in out.items()}
            sampler.offer({"update": u, "pool": u % len(pool),
                           "pre": store, "res": res, "post": new})
            store = new
    run_s = time.perf_counter() - t0
    del nets_low
    gc.collect()
    networks = gen.reference_networks(cfg, seed, dev, frame0, s)
    readings = []
    with torch.no_grad():
        for smp in sampler.samples():
            frames = torch.from_numpy(pool[smp["pool"]]).to(dev)
            readings.append(judge.judge_sample(
                networks, frames, smp["pre"],
                judge.as_result(smp["res"], dev, True), smp["post"], s))
    live = [int(np.asarray(smp["res"]["tracks.valid"]).sum())
            for smp in sampler.samples()]
    return {"side": f"control-{precision}", "seed": seed,
            "readings": judge.combine(readings),
            "judge": judge.info(readings), "run_s": run_s,
            "live_tracks": live}


def program_readings(workload: str, seed: int, seconds: float,
                     side: str = "program"):
    """One whole benchmark run (trace off) and its readings."""
    args = argparse.Namespace(workload=workload, seed=seed,
                              seconds=seconds, trace=0)
    try:
        out = run.run(args)
    except run.Abort as exc:
        return {"side": side, "seed": seed, "abort": str(exc)}
    gc.collect()
    torch.cuda.empty_cache()
    return {"side": side, "seed": seed, "correct": out["correct"],
            "readings": {k: v["value"] for k, v in out["checks"].items()},
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "info": out["info"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control-updates", type=int, default=24)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = lambda text: [int(x) for x in text.split(",") if x]  # noqa: E731
    rows = []
    for seed in seeds(args.program_seeds):
        rows.append(program_readings(args.workload, seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    for name in [x for x in args.faults.split(",") if x]:
        for seed in seeds(args.fault_seeds):
            with faults.FAULTS[name]():
                rows.append(program_readings(args.workload, seed,
                                             args.seconds, f"fault-{name}"))
            print(json.dumps(rows[-1]), flush=True)
    for seed in seeds(args.control_seeds):
        rows.append(control_readings(args.workload, seed,
                                     args.control_updates))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(dict(r, workload=args.workload)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
