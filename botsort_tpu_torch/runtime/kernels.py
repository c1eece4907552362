"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/botsort_tpu_torch/`` at first use and loaded with ``ctypes`` —
no PyTorch headers, so a build takes seconds. The library's file name
carries a hash of the source, every shared header in ``csrc/`` and the
flags, so an edited source or header rebuilds. ``load_all`` starts one
``nvcc`` per source at once.

``--fmad=false`` keeps nvcc from contracting a*b+c into FMAs: the
assignment kernels must reproduce their plain PyTorch versions' float32
operations bit for bit (ops/assignment.py). The depthwise stencil (K5)
does too, with its products and sums written as __fmul_rn/__fadd_rn,
which no flag contracts, and so do the batch norm pass (K6), its
backward (K6b), the crop-resize (K7) and the NMS fixpoint (K8); K4
(stem_stage1) is held to a tolerance, and the hierarchy scan (K10) only
compares. All ten libraries share these flags.

Every entry point takes the raw handle of the CUDA stream to launch on;
``current_stream`` gives it to every wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "botsort_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Every kernel of the port: K1/K2 (cascade_lap), K3 (jv_lap), K4
# (stem_stage1), K5 (dw_conv3x3), K6 (bn_act), its backward K6b
# (bn_act_backward), K7 (crop_resize), K8 (nms_fixpoint), K9 with the
# conditional-graph assembly (graph_cond) and K10 (hierarchy_scan).
KERNELS = ("cascade_lap", "jv_lap", "stem_stage1", "dw_conv3x3", "bn_act",
           "bn_act_backward", "crop_resize", "nms_fixpoint", "graph_cond",
           "hierarchy_scan")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent building in this process, nvcc's output).
BUILD_INFO: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library lives: the file name carries a
    hash of the source, every shared header and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    if no library for the current source exists."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC_DIR / f"{name}.cu"
    so = library_path(name)
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        BUILD_INFO[name] = (time.perf_counter() - t0,
                            proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib


def current_stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream of ``device`` (the current
    device if it has no index). It is the handle
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object first: that costs several microseconds a
    call, and K5 is called 13 times per face encoder call."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def load_all(names: Sequence[str] = KERNELS) -> Dict[str, ctypes.CDLL]:
    """``load`` every named kernel (all of them by default), the builds
    running concurrently."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        libs = list(pool.map(load, names))
    return dict(zip(names, libs))
