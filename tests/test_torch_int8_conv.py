"""K2 (tpu_unet_torch/ops/kernels/int8_conv.py) on the CPU: its plain version
bit for bit against the JAX package's unfused reference and its Pallas kernel
in interpret mode, at tests/test_pallas_int8_conv.py's shapes and more. The
CUDA kernel is held to the plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from tpu_unet.ops.pallas.int8_conv import conv3x3_int8_fused, conv3x3_int8_reference
from tpu_unet_torch.ops.kernels.int8_conv import (conv3x3_int8, conv3x3_int8_plain,
                                                  pad_channels)


def _case(shape, seed, lo=-127):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(lo, 128, (n, h, w, cin)).astype(np.int8)
    k = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    scale = (rng.random(cout) * 1e-3 + 1e-4).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, k, scale, bias, np.float32(0.05)


def _port(x, k, scale, bias, s_out, relu, pad_w=False):
    """The port's wrapper on CPU tensors, with the kernel in K2's (Cout,3,3,Cin)
    layout (its Cin zero-padded by pad_channels with ``pad_w``)."""
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 0, 1, 2)))
    return conv3x3_int8(torch.from_numpy(x), pad_channels(w) if pad_w else w,
                        torch.from_numpy(scale), torch.from_numpy(bias),
                        torch.tensor(s_out), relu=relu).numpy()


@pytest.mark.parametrize("shape,row_tile", [
    ((2, 8, 8, 16, 24), 4),     # Cin != Cout
    ((1, 16, 24, 8, 8), 8),     # non-square spatial
    ((3, 8, 16, 32, 16), 8),    # row_tile == H
])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_matches_jax_bit_for_bit(shape, row_tile, relu):
    x, k, scale, bias, s_out = _case(shape, seed=sum(shape) + relu)
    ref = np.asarray(conv3x3_int8_reference(x, k, scale, bias, s_out, relu=relu))
    fused = np.asarray(conv3x3_int8_fused(x, k, scale, bias, s_out, relu=relu,
                                          row_tile=row_tile, interpret=True))
    got = _port(x, k, scale, bias, s_out, relu)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, fused)


def test_saturation_clips_instead_of_wrapping():
    n, h, w, c = 1, 8, 8, 8
    x = np.full((n, h, w, c), 127, np.int8)
    k = np.full((3, 3, c, c), 127, np.int8)
    scale, bias = np.ones(c, np.float32), np.zeros(c, np.float32)
    ref = np.asarray(conv3x3_int8_reference(x, k, scale, bias, np.float32(1.0)))
    got = _port(x, k, scale, bias, np.float32(1.0), True)
    np.testing.assert_array_equal(got, ref)
    assert got.max() == 127


@pytest.mark.parametrize("pad_w", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_three_input_channels(relu, pad_w):
    """inc.conv1's Cin=3 (the CUDA wrapper pads it to 32 with zeros), with the
    weights as they are or already padded, as _QuantExec keeps them."""
    x, k, scale, bias, s_out = _case((2, 16, 16, 3, 64), seed=11)
    ref = np.asarray(conv3x3_int8_reference(x, k, scale, bias, s_out, relu=relu))
    np.testing.assert_array_equal(_port(x, k, scale, bias, s_out, relu, pad_w), ref)


def test_wide_input_is_exact_where_float32_is_not():
    """Cin=128 with all-extreme values: 9*128*127**2 > 2**24, so a float32
    accumulator would round; the plain version accumulates in float64."""
    n, h, w, cin, cout = 1, 6, 6, 128, 8
    rng = np.random.default_rng(5)
    x = rng.choice(np.array([-127, 127], np.int8), (n, h, w, cin))
    k = rng.choice(np.array([-127, 127], np.int8), (3, 3, cin, cout))
    k[..., 0] = x[0, 0, 0, :][None, None, :]  # one channel near the largest sum
    scale = np.full(cout, 1.0 / 2 ** 16, np.float32)
    bias = np.full(cout, 0.25, np.float32)
    s_out = np.float32(0.37)
    for relu in (True, False):
        ref = np.asarray(conv3x3_int8_reference(x, k, scale, bias, s_out, relu=relu))
        np.testing.assert_array_equal(_port(x, k, scale, bias, s_out, relu), ref)


def test_cpu_wrapper_launches_nothing_and_checks_inputs():
    x, k, scale, bias, s_out = _case((1, 8, 8, 8, 8), seed=2)
    before = conv3x3_int8.launches
    _port(x, k, scale, bias, s_out, True)
    assert conv3x3_int8.launches == before
    kt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 0, 1, 2)))
    with pytest.raises(ValueError):  # HWIO instead of K2's (Cout, 3, 3, Cin)
        conv3x3_int8(torch.from_numpy(x), torch.from_numpy(k).permute(3, 2, 0, 1),
                     torch.from_numpy(scale), torch.from_numpy(bias), torch.tensor(s_out))
    with pytest.raises(TypeError):
        conv3x3_int8(torch.from_numpy(x).float(), kt, torch.from_numpy(scale),
                     torch.from_numpy(bias), torch.tensor(s_out))
    plain = conv3x3_int8_plain(torch.from_numpy(x), kt, torch.from_numpy(scale),
                               torch.from_numpy(bias), torch.tensor(s_out))
    assert plain.is_contiguous() and plain.shape == (1, 8, 8, 8)
