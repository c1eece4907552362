"""botsort_tpu_torch — the PyTorch + CUDA port of botsort_tpu.

The JAX package ``botsort_tpu`` is the reference; this package runs the
same tracker, one stream or B streams per step, on an NVIDIA GPU (or,
with the plain PyTorch versions of its kernels, on the CPU for tests).
Layout mirrors the JAX package so each module's counterpart is easy to
find:

  config.py   tracker, NMS and pipeline configuration
  ops/        boxes, Kalman filter, assignment (plain + CUDA K1, K2, K3),
              crops, NMS, box hierarchy
  models/     YOLOX, FastReID SBS-S50, FaceReID as ``torch.nn`` modules,
              their kernels' wrappers and int8 quantization
  track/      tensor track store + the BoT-SORT association cascade
  pipeline/   the per-frame step (batched over streams), the host
              facades, host box objects
  parallel/   streams split over several devices
  train/      the batch-hard triplet ReID trainer
  runtime/    kernel build/load, Flax weight bridge, model bundles,
              exported programs, the serving envelope, native LAPJV
  cli/        demo, multitrack, trace, export, serve and warm-up entry
              points
  io/         video I/O and frame drawing for the CLIs (OpenCV)
  utils/      stage timers, device trace, terminal colours
  csrc/       hand-written CUDA kernels (built at first use)
  examples/   library usage

Nothing here imports ``jax``, ``flax`` or the JAX package, so the port
runs on a machine that has only PyTorch.
"""

__version__ = "0.1.0"

from botsort_tpu_torch.config import (  # noqa: F401
    NMSConfig,
    PipelineConfig,
    TrackerConfig,
)
