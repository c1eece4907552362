"""The port's small utilities against the JAX package's:
runtime/native.py (the native LAPJV oracle, built into the port's build
directory), utils/colors.py, utils/profiling.py::device_trace, and the
two examples on a MINI CPU run."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from botsort_tpu.runtime import native as jnative
from botsort_tpu.utils import colors as jcolors
from botsort_tpu_torch.runtime import native
from botsort_tpu_torch.runtime.kernels import BUILD_DIR
from botsort_tpu_torch.utils import colors
from botsort_tpu_torch.utils.profiling import device_trace
from tests.test_torch_pipeline import REPO


def test_native_lapjv_equals_jax_native():
    rng = np.random.default_rng(4)
    for n, m, limit in ((12, 9, 0.8), (5, 14, 0.5), (16, 16, 0.7), (0, 3, 0.5),
                        (7, 0, 0.5), (30, 40, 0.3)):
        cost = rng.uniform(0, 1, (n, m))
        got = native.lapjv_cost_limit(cost, limit)
        want = jnative.lapjv_cost_limit(cost, limit)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # Built into the port's build directory, not into native/.
    assert native.library_path().parent == BUILD_DIR
    assert native.library_path().is_file()


def test_colors_equal_jax():
    for name in ("red", "green", "yellow", "blue", "magenta", "cyan",
                 "bold"):
        assert getattr(colors, name)("x 1") == getattr(jcolors, name)("x 1")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0


@pytest.mark.parametrize("example", ["quickstart", "multi_stream"])
def test_examples_run_mini_on_the_cpu(tmp_path, example):
    paths = []
    for i in range(2 if example == "multi_stream" else 1):
        path = str(tmp_path / f"v{i}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 15,
                                 (160, 120))
        rng = np.random.default_rng(i)
        for _ in range(2):
            writer.write(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
        writer.release()
        paths.append(path)
    extra = ["--chips", "2"] if example == "multi_stream" else []
    proc = subprocess.run(
        [sys.executable, "-m", f"botsort_tpu_torch.examples.{example}",
         *paths, "-ep", "cpu", "--mini", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = ("tracked 2 frames" if example == "quickstart"
            else "2 steps of 2 streams over 2 devices")
    assert want in proc.stdout
