"""A short first look at kernel K4 (csrc/stem_stage1.cu) on the card.

Builds the kernel and prints what ``nvcc -Xptxas -v`` says of it; calls the
C entry point on seeded inputs at a few shapes (the general path's small
widths, full width with whole, partial and many tiles) and holds every
scratch buffer and the output against the layer of the plain version that
produced it, so a fault shows at the first layer it touches; then times one
call at 50 and 128 crops and prints ``torch.profiler``'s device time of
each of its CUDA kernels. Needs a CUDA card:

    python -m botsort_tpu_torch.cli.k4_probe
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch
import torch.nn.functional as F

from botsort_tpu_torch.models import fastreid
from botsort_tpu_torch.models import fastreid_fused as ff
from botsort_tpu_torch.models.common import cast_compute
from botsort_tpu_torch.runtime import assets, kernels

FULL = dict(stage_blocks=(3, 1, 1, 1))
SMALL = dict(stage_blocks=(3, 1, 1, 1), stage_widths=(8, 16, 32, 64),
             stem_width=8)
CASES = ((2, 32, 16, SMALL), (1, 256, 128, FULL), (3, 40, 16, FULL),
         (7, 256, 128, FULL), (3, 384, 128, FULL))


def trunk(dev, seed, **layout):
    rng = np.random.default_rng(seed)
    model = fastreid.ResNeSt50(fused_stem=True, **layout)
    assets.perturb_norms_(assets.seeded_init_(model, rng), rng)
    return cast_compute(model, torch.bfloat16).to(dev).eval()


def rel(got, want):
    got, want = got.float(), want.float()
    return (float((got - want).norm() / want.norm().clamp(min=1e-6)),
            float((got - want).abs().max() / want.abs().max().clamp(
                min=1e-6)))


def plain_layers(x, folded):
    """stem_stage1_plain, keeping what each layer stores (NCHW)."""
    kept = {}
    h = x.permute(0, 3, 1, 2)
    for i, fc in enumerate(folded.stem):
        h = kept[f"stem{i}"] = ff._conv_relu(h, fc)
    h = kept["pooled"] = F.max_pool2d(h.float(), 3, 2, 1).to(torch.bfloat16)
    for b, blk in enumerate(folded.blocks):
        t = ff._conv_relu(h, blk.conv_in)
        y = ff._conv_relu(t, blk.conv_split)
        out = ff._conv_acc(ff._split_attention(y, blk), blk.conv_out)
        sc = (ff._conv_acc(h, blk.shortcut) if blk.shortcut is not None
              else h.float())
        h = torch.relu(out + sc).to(torch.bfloat16)
        kept[f"t{b}"], kept[f"y{b}"], kept[f"x{b}"] = t, y, h
    return kept


def check(dev, n, h, w, layout):
    folded = trunk(dev, 7, **layout).folded_stem_stage1()
    x = torch.from_numpy(np.random.default_rng(8).normal(
        0, 1, (n, h, w, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    sw, width = folded.stem_width, folded.width
    plan, total = ff._launch_plan(n, h, w, sw, width)
    offsets, _ = ff.scratch_layout(n, h, w, sw, width)
    out = torch.zeros((n, 4 * width, h // 4, w // 4), dtype=torch.bfloat16,
                      device=dev)
    scratch = torch.zeros((total,), dtype=torch.uint8, device=dev)
    rc = ff._lib().stem_stage1_launch(
        x.data_ptr(), ctypes.cast(ff._prepared(folded, dev), ctypes.c_void_p),
        out.data_ptr(), scratch.data_ptr(), plan, n, h, w, sw, width,
        kernels.current_stream(dev))
    print(f"N={n} {h}x{w} stem width {sw}, stage-1 width {width}: launch "
          f"returned {rc}")
    torch.cuda.synchronize()
    want = plain_layers(x, folded)

    def buf(name, *shape):
        nbytes = 2 * int(np.prod(shape))
        return scratch[offsets[name]:offsets[name] + nbytes].view(
            torch.bfloat16).view(*shape).permute(0, 3, 1, 2)

    h1, w1, h2, w2 = h // 2, w // 2, h // 4, w // 4
    # What each buffer holds when the call ends (stem_a: stem2's output;
    # t and y: the last block's).
    pairs = [("stem1", buf("stem_b", n, h1, w1, sw), "stem1"),
             ("stem2", buf("stem_a", n, h1, w1, 2 * sw), "stem2"),
             ("pooled", buf("pooled", n, h2, w2, 2 * sw), "pooled"),
             ("block 0", buf("x1", n, h2, w2, 4 * width), "x0"),
             ("block 1", buf("x2", n, h2, w2, 4 * width), "x1"),
             ("block 2 first 1x1", buf("t", n, h2, w2, width), "t2"),
             ("block 2 grouped", buf("y", n, h2, w2, 2 * width), "y2"),
             ("output", out, "x2")]
    worst = 0.0
    for name, got, key in pairs:
        r, m = rel(got, want[key])
        worst = max(worst, r)
        print(f"  {name:18s} relative L2 {r:.3e}, max {m:.3e} of scale")
    same = torch.equal(ff.stem_stage1_cuda(x, folded), out)
    print(f"  the wrapper's output equals this call's: {same}")
    return rc == 0 and same and worst <= 1e-2


def time_split(dev, n):
    from torch.profiler import ProfilerActivity, profile

    folded = trunk(dev, 7, **FULL).folded_stem_stage1()
    x = torch.randn(n, 256, 128, 3, device=dev).to(torch.bfloat16)
    for _ in range(2):
        ff.stem_stage1_cuda(x, folded)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        ff.stem_stage1_cuda(x, folded)
    end.record()
    torch.cuda.synchronize()
    print(f"N={n} 256x128: {start.elapsed_time(end) / 10:.4f} ms a call")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ff.stem_stage1_cuda(x, folded)
        torch.cuda.synchronize()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "device_time", None)
            print(f"    {ev.name[:72]:72s} "
                  f"{ev.cuda_time if us is None else us:8.1f} us")


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kernels.load("stem_stage1")
    secs, output = kernels.BUILD_INFO.get("stem_stage1", (0.0, ""))
    print(f"build: {secs:.2f} s")
    for line in output.splitlines():
        if any(word in line for word in ("registers", "spill", "Compiling",
                                         "warning", "error")):
            print(line.strip()[:200])
    ok = all([check(dev, *case) for case in CASES])
    for n in (50, 128):
        time_split(dev, n)
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
