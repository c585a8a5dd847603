"""The frozen FLOP formulas equal torch's count over the reference models."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, inputs
from port_bench.reference.ladder import Ladder


@pytest.mark.parametrize("config", [
    {"model": "anomaly_unet", "family": "anomaly_unet", "base_features": 4,
     "image_height": 32, "image_width": 32},
    {"model": "seg_unet", "family": "seg_unet", "base_features": 8, "n_classes": 3,
     "image_height": 64, "image_width": 32},
], ids=["anomaly_unet", "seg_unet"])
def test_forward_flops_match_the_counter(config):
    model = Ladder(config)
    p = inputs.weights(model.specs(), 3, "cpu")
    x = torch.zeros(2, 3, config["image_height"], config["image_width"])
    with FlopCounterMode(display=False) as counter:
        model.forward(model.fold(p), x, bn="folded")
    assert counter.get_total_flops() == 2 * flops.forward_per_image(config)
    if config["model"] == "anomaly_unet":
        with FlopCounterMode(display=False) as counter:
            model.forward(model.fold(p), x, bn="folded", decoders=model.decoders[:1])
        assert counter.get_total_flops() == 2 * flops.forward_per_image(config, score_only=True)


def test_k2_bound_is_the_larger_of_operations_and_bytes():
    ops_bound = flops.conv3x3_int8_bound_s(128, 16, 16, 1024, 1024)
    assert ops_bound == pytest.approx(2 * 9 * 1024 * 1024 * 256 * 128 / flops.PEAK_INT8)
    byte_bound = flops.conv3x3_int8_bound_s(128, 256, 256, 3, 64)
    assert byte_bound == pytest.approx((128 * 256 * 256 * 67 + 9 * 3 * 64 + 8 * 64)
                                       / flops.PEAK_HBM)
