"""The assignment kernels on the card.

``cascade_solve_cuda`` wraps csrc/cascade_lap.cu, the fused three-pass
cascade solver: kernel K1 at one stream (replacing the TPU kernel
botsort_tpu/ops/assignment_pallas.py::_cascade_kernel) and K2 at B streams
in one launch (replacing ``_cascade_kernel_ls``). Its plain PyTorch version
is ops/assignment.py::cascade_solve_plain. ``jv_solve_cuda`` wraps
csrc/jv_lap.cu, kernel K3 (replacing ``_jv_kernel``): one square
Jonker-Volgenant solve per problem; its plain version is
ops/assignment.py::jv_solve_plain. ``solve_cascade_masked`` and
``solve_masked`` dispatch between kernel and plain version by the tensors'
device.

Each problem (each stream of a K2 batch) is one thread block: of one warp
up to S = N + D = 256 columns (csrc/lap_common.cuh), of up to 1024
threads above that, up to ``MAX_COLUMNS`` (K1/K2: as long as a stream's
state fits in a block's shared memory, 4 (7 S + N) bytes without the
staged costs, so about S = 7,700 at N = D).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from botsort_tpu_torch.ops.assignment import MAX_ITERS, half_limit
from botsort_tpu_torch.runtime import kernels

_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a Hopper block can use
MAX_COLUMNS = 8 * 1024    # lap_common.cuh's kMaxS


def _lib() -> ctypes.CDLL:
    lib = kernels.load("cascade_lap")
    fn = lib.cascade_lap_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.cascade_lap_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.cascade_lap_smem_bytes.restype = ctypes.c_int
    return lib


def _jv_lib() -> ctypes.CDLL:
    lib = kernels.load("jv_lap")
    fn = lib.jv_lap_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.jv_lap_smem_bytes.argtypes = [ctypes.c_int]
        lib.jv_lap_smem_bytes.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cascade_solve_cuda(costs: torch.Tensor, masks: torch.Tensor,
                       big: torch.Tensor, limits: Sequence[float],
                       max_iters: int = MAX_ITERS
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """costs [B, 3, N, D] f32, masks [B, 3N+3D] int32, big [B] f32, all
    contiguous on one CUDA device -> (cfr [B, 3, N], rfc [B, 3, D]) int32.

    One warp per stream (one block above N + D = 256), launched on the
    current stream; nothing is synchronised.
    ``cascade_solve_cuda.launches`` counts launches at
    B = 1 (K1), ``cascade_solve_cuda.batched_launches`` those at B > 1
    (K2).
    """
    if not costs.is_cuda:
        raise ValueError("cascade_solve_cuda takes CUDA tensors; the plain "
                         "version is ops.assignment.cascade_solve_plain")
    if costs.dim() != 4 or costs.shape[1] != 3:
        raise ValueError(f"costs must be [B, 3, N, D], got "
                         f"{tuple(costs.shape)}")
    bsz, _, n, d = costs.shape
    if bsz < 1 or n < 1 or d < 1:
        raise ValueError(f"empty problem {tuple(costs.shape)}")
    dev = costs.device
    _check(costs, "costs", torch.float32, (bsz, 3, n, d), dev)
    _check(masks, "masks", torch.int32, (bsz, 3 * (n + d)), dev)
    _check(big, "big", torch.float32, (bsz,), dev)
    if len(limits) != 3:
        raise ValueError("limits must hold the three pass limits")
    if n + d > MAX_COLUMNS:
        raise ValueError(f"N+D={n + d} is above {MAX_COLUMNS}")
    lib = _lib()
    smem = lib.cascade_lap_smem_bytes(n, d)
    if not 0 <= smem <= _SMEM_LIMIT:
        raise ValueError(f"N+D={n + d} needs {smem} B of shared memory "
                         f"(limit {_SMEM_LIMIT})")
    cfr = torch.empty((bsz, 3, n), dtype=torch.int32, device=dev)
    rfc = torch.empty((bsz, 3, d), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cascade_lap_launch(
            costs.data_ptr(), masks.data_ptr(), big.data_ptr(),
            cfr.data_ptr(), rfc.data_ptr(), bsz, n, d,
            *(half_limit(x) for x in limits), int(max_iters),
            kernels.current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"cascade_lap launch failed: CUDA error {rc}")
    if bsz == 1:
        cascade_solve_cuda.launches += 1
    else:
        cascade_solve_cuda.batched_launches += 1
    return cfr, rfc


cascade_solve_cuda.launches = 0
cascade_solve_cuda.batched_launches = 0


def jv_solve_cuda(ext: torch.Tensor, p0: torch.Tensor,
                  live_order: torch.Tensor, n_live: torch.Tensor,
                  max_iters: int = MAX_ITERS) -> torch.Tensor:
    """ext [B, S, S] f32, p0 [B, S] int32, live_order [B, S] int32,
    n_live [B] int32, all contiguous on one CUDA device -> owner [B, S]
    int32 (see ops.assignment.jv_solve_plain for the contract).

    One warp per problem (one block above S = 256), launched on the
    current stream; nothing is synchronised. ``jv_solve_cuda.launches``
    counts launches.
    """
    if not ext.is_cuda:
        raise ValueError("jv_solve_cuda takes CUDA tensors; the plain "
                         "version is ops.assignment.jv_solve_plain")
    if ext.dim() != 3 or ext.shape[1] != ext.shape[2]:
        raise ValueError(f"ext must be [B, S, S], got {tuple(ext.shape)}")
    bsz, s, _ = ext.shape
    if bsz < 1 or s < 1:
        raise ValueError(f"empty problem {tuple(ext.shape)}")
    dev = ext.device
    _check(ext, "ext", torch.float32, (bsz, s, s), dev)
    _check(p0, "p0", torch.int32, (bsz, s), dev)
    _check(live_order, "live_order", torch.int32, (bsz, s), dev)
    _check(n_live, "n_live", torch.int32, (bsz,), dev)
    if s > MAX_COLUMNS:
        raise ValueError(f"S={s} is above {MAX_COLUMNS}")
    lib = _jv_lib()
    smem = lib.jv_lap_smem_bytes(s)
    if not 0 <= smem <= _SMEM_LIMIT:
        raise ValueError(f"S={s} needs {smem} B of shared memory "
                         f"(limit {_SMEM_LIMIT})")
    owner = torch.empty((bsz, s), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.jv_lap_launch(
            ext.data_ptr(), p0.data_ptr(), live_order.data_ptr(),
            n_live.data_ptr(), owner.data_ptr(), bsz, s, int(max_iters),
            kernels.current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"jv_lap launch failed: CUDA error {rc}")
    jv_solve_cuda.launches += 1
    return owner


jv_solve_cuda.launches = 0
