"""Device probe (port of botsort_tpu/runtime/device.py::platform_summary).

The JAX package reports its backend; the port reports PyTorch's: whether a
card is there, how many, their names, and the torch and CUDA versions. The
JAX package's persistent compilation cache has no counterpart here: the
kernels are built once per source into build/ (runtime/kernels.py) and the
step's programs are exported with cli/export.py.
"""

from __future__ import annotations

import torch


def platform_summary() -> dict:
    """{"backend", "device_count", "devices", "torch", "cuda"}: "cuda" and
    the cards' names where a card is available, else "cpu"."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        return {"backend": "cuda", "device_count": n,
                "devices": [torch.cuda.get_device_name(i) for i in range(n)],
                "torch": torch.__version__, "cuda": torch.version.cuda}
    return {"backend": "cpu", "device_count": 1, "devices": ["cpu"],
            "torch": torch.__version__, "cuda": torch.version.cuda}
