"""The analytic counts against YOLOX's published size."""

import pytest

from portbench import counts

# YOLOX-X as published (YOLOX README, COCO, test size 640): 99.1 M
# parameters, 281.9 GFLOPs, with an 80-class head.
YOLOX_X_PARAMS = 99.1e6
YOLOX_X_GFLOPS = 281.9
HIDDEN = 320          # the head's width at width 1.25
LEVELS_640 = (80 * 80, 40 * 40, 20 * 20)


def test_yolox_x_at_640_matches_the_published_size():
    """The walk counts 4 classes; each of the three levels' class
    predictor (a 1x1 conv from 320 channels, with bias) has 76 outputs
    more at 80 classes. Tolerance 1%: the published figures are rounded
    to a tenth, and YOLOX's counter (thop) adds a few element-wise
    operations of the norms that this count leaves out."""
    c = counts.network_counts("full", "detector", (640, 640))
    params = c["params"] + 3 * (HIDDEN * 76 + 76)
    flops = c["flops"] + 2 * 76 * HIDDEN * sum(LEVELS_640)
    assert params == pytest.approx(YOLOX_X_PARAMS, rel=0.01)
    assert flops / 1e9 == pytest.approx(YOLOX_X_GFLOPS, rel=0.01)


def test_the_cells_input_sizes_scale_the_work():
    det = counts.network_counts("full", "detector", (480, 640))
    assert det["flops"] == pytest.approx(
        counts.network_counts("full", "detector", (640, 640))["flops"]
        * 0.75, rel=1e-6)
    b256 = counts.network_counts("full", "body", (256, 128))
    b384 = counts.network_counts("full", "body", (384, 128))
    assert b384["flops"] == pytest.approx(1.5 * b256["flops"], rel=0.01)
    assert b256["params"] == b384["params"]
    assert b384["norm_bytes"] > b256["norm_bytes"] > 0


def test_norm_bytes_of_one_norm_by_hand():
    """The mini detector's first norm: a [1, 16, 48, 64] bfloat16 input
    read and written once, and three float32 vectors of 16; the walk's
    detector total holds it."""
    from portbench.reference import nets

    model = nets.build("mini")[0]
    one = []

    def hook(m, inputs, out):
        one.append(inputs[0].shape)
    h = model.CSPDarknet_0.Focus_0.BatchNorm_0.register_forward_hook(hook)
    import torch
    with torch.no_grad():
        model(torch.zeros((1, 96, 128, 3), device="meta"))
    h.remove()
    assert one == [(1, 16, 48, 64)]
    first = 2 * 2 * 16 * 48 * 64 + 3 * 4 * 16
    total = counts.network_counts("mini", "detector", (96, 128))
    assert total["norm_bytes"] > first
    assert total["norm_bytes"] % 2 == 0
