"""Evaluate a tracking trace against ground truth (MOTA/MOTP/IDF1).

The port of botsort_tpu/cli/eval_mot.py. Usage:
  python -m botsort_tpu_torch.cli.eval_mot --gt gt.txt --hyp trace.csv

Both files in MOT challenge CSV format (frame,id,x,y,w,h,...), e.g. the
output of cli/eval_trace.py and MOT17/MOT20 gt.txt files. Prints one JSON
line; diff two runs (the port's trace against another) to compare them.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser

from botsort_tpu_torch.eval.mot_metrics import evaluate


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--gt", required=True, help="ground-truth trace")
    parser.add_argument("--hyp", required=True, help="hypothesis trace")
    parser.add_argument("--iou", type=float, default=0.5)
    args = parser.parse_args(argv)
    out = evaluate(args.gt, args.hyp, args.iou)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
