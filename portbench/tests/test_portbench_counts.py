"""The analytic counts against YOLOX's published size, and the committed
configurations' counts exactly."""

import pytest
import torch

from portbench import counts, networks, registry
from portbench.tests import minicell

# YOLOX-X as published (YOLOX README, COCO, test size 640): 99.1 M
# parameters, 281.9 GFLOPs, with an 80-class head.
YOLOX_X_PARAMS = 99.1e6
YOLOX_X_GFLOPS = 281.9
HIDDEN = 320          # the head's width at width 1.25
LEVELS_640 = (80 * 80, 40 * 40, 20 * 20)
MOT17 = registry.config("yolox_x-mot17_sbs_s50_256")["models"]

# network -> (flops, norm_bytes, params) per image at the cell's sizes.
EXACT = {
    "yolox_x-mot17_sbs_s50_256": {
        "detector": (210_750_912_000, 390_365_760, 98_998_267),
        "body": (9_329_283_072, 42_247_936, 25_438_337),
        "face": (196_243_456, 8_927_104, 2_551_808)},
    "yolox_x-mot20_sbs_s50_384": {
        "detector": (210_750_912_000, 390_365_760, 98_998_267),
        "body": (13_992_038_400, 63_153_920, 25_438_337),
        "face": (196_243_456, 8_927_104, 2_551_808)},
}


def test_yolox_x_at_640_matches_the_published_size():
    """The walk counts 4 classes; each of the three levels' class
    predictor (a 1x1 conv from 320 channels, with bias) has 76 outputs
    more at 80 classes. Tolerance 1%: the published figures are rounded
    to a tenth, and YOLOX's counter (thop) adds a few element-wise
    operations of the norms that this count leaves out."""
    c = counts.network_counts(MOT17["detector"], (640, 640))
    params = c["params"] + 3 * (HIDDEN * 76 + 76)
    flops = c["flops"] + 2 * 76 * HIDDEN * sum(LEVELS_640)
    assert params == pytest.approx(YOLOX_X_PARAMS, rel=0.01)
    assert flops / 1e9 == pytest.approx(YOLOX_X_GFLOPS, rel=0.01)


@pytest.mark.parametrize("config", sorted(EXACT))
def test_the_committed_configurations_count_exactly(config):
    """The counts the mfu and roofline readers divide by, as the walk of
    the published networks gave them before configurations named their
    networks."""
    got = counts.cell_counts(registry.config(config))
    assert {n: (c["flops"], c["norm_bytes"], c["params"])
            for n, c in got.items()} == EXACT[config]


def test_the_cells_input_sizes_scale_the_work():
    det = counts.network_counts(MOT17["detector"], (480, 640))
    assert det["flops"] == pytest.approx(
        counts.network_counts(MOT17["detector"], (640, 640))["flops"]
        * 0.75, rel=1e-6)
    b256 = counts.network_counts(MOT17["body"], (256, 128))
    b384 = counts.network_counts(MOT17["body"], (384, 128))
    assert b384["flops"] == pytest.approx(1.5 * b256["flops"], rel=0.01)
    assert b256["params"] == b384["params"]
    assert b384["norm_bytes"] > b256["norm_bytes"] > 0


def test_float32_norms_are_read_from_the_entry():
    """The body's last norm counted at 4 bytes an element where the entry
    lists it, at 2 where it does not: 2 x 2 x 2048 bytes apart."""
    plain = dict(MOT17["body"])
    del plain["float32_norms"]
    with_it = counts.network_counts(MOT17["body"], (256, 128))
    without = counts.network_counts(plain, (256, 128))
    assert with_it["norm_bytes"] - without["norm_bytes"] == 2 * 2 * 2048
    assert with_it["flops"] == without["flops"]


def test_norm_bytes_of_one_norm_by_hand():
    """The mini detector's first norm: a [1, 16, 48, 64] bfloat16 input
    read and written once, and three float32 vectors of 16; the walk's
    detector total holds it."""
    entry = minicell.MINI_MODELS["detector"]
    model = networks.reference_network(entry)
    one = []

    def hook(m, inputs, out):
        one.append(inputs[0].shape)
    h = model.CSPDarknet_0.Focus_0.BatchNorm_0.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros((1, 96, 128, 3), device="meta"))
    h.remove()
    assert one == [(1, 16, 48, 64)]
    first = 2 * 2 * 16 * 48 * 64 + 3 * 4 * 16
    total = counts.network_counts(entry, (96, 128))
    assert total["norm_bytes"] > first
    assert total["norm_bytes"] % 2 == 0
