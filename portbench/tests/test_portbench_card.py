"""One cell, a short window, on the card (skips without one)."""

import json
import subprocess
import sys

import pytest

from portbench import registry


@pytest.mark.cuda
def test_one_short_cell_runs_and_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mot17_256.loaded.1stream", "--seed", "3141592653", "--seconds", "3",
         "--trace", "0"], cwd=registry.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"frames_per_s", "update_ms_p50",
                                    "update_ms_p95", "setup_s"}
    assert line["device"]["platform"] == "gpu"
