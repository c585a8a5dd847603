"""K2 (tpu_unet_torch/ops/kernels/int8_conv.py) on the CPU: its plain version
bit for bit against the JAX package's unfused reference and its Pallas kernel
in interpret mode, at tests/test_pallas_int8_conv.py's shapes and more. The
CUDA kernel is held to the plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from tpu_unet.ops.pallas.int8_conv import conv3x3_int8_fused, conv3x3_int8_reference
from tpu_unet_torch.ops.kernels.int8_conv import (conv3x3_int8, conv3x3_int8_plain,
                                                  pack_first_layer, pack_weights,
                                                  pad_channels)


def _case(shape, seed, lo=-127):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(lo, 128, (n, h, w, cin)).astype(np.int8)
    k = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    scale = (rng.random(cout) * 1e-3 + 1e-4).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, k, scale, bias, np.float32(0.05)


def _port(x, k, scale, bias, s_out, relu, packed_w=False):
    """The port's wrapper on CPU tensors, with the kernel in K2's (Cout,3,3,Cin)
    layout (packed by pack_weights with ``packed_w``)."""
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 0, 1, 2)))
    return conv3x3_int8(torch.from_numpy(x), pack_weights(w, x.shape[3]) if packed_w else w,
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


@pytest.mark.parametrize("packed_w", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_three_input_channels(relu, packed_w):
    """inc.conv1's Cin=3 (the first-layer kernel on CUDA), with the weights as
    they are or packed by pack_first_layer, as _QuantExec keeps them."""
    x, k, scale, bias, s_out = _case((2, 16, 16, 3, 64), seed=11)
    ref = np.asarray(conv3x3_int8_reference(x, k, scale, bias, s_out, relu=relu))
    np.testing.assert_array_equal(_port(x, k, scale, bias, s_out, relu, packed_w), ref)


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


def _im2col_conv(x, w_packed, scale, bias, s_out, relu):
    """The first-layer kernel's arithmetic in numpy: each pixel's 3x3 x Cin
    neighbourhood as one K row (k = tap * Cin + ci, zero padded to 32) times
    pack_first_layer's (Cout, 32) weights, then _QuantExec's requant."""
    n, h, w, cin = x.shape
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    taps = [xp[:, ky:ky + h, kx:kx + w, :] for ky in range(3) for kx in range(3)]
    rows = np.concatenate(taps, axis=-1)  # (n, h, w, 9 * cin), k = tap * cin + ci
    rows = np.pad(rows, ((0, 0), (0, 0), (0, 0), (0, 32 - 9 * cin)))
    acc = rows @ w_packed.astype(np.int64).T
    y = acc.astype(np.float32) * scale + bias
    lo = -127
    if relu:
        y, lo = np.maximum(y, np.float32(0)), 0
    return np.clip(np.round(y / s_out), lo, 127).astype(np.int8)


@pytest.mark.parametrize("relu", [True, False])
def test_pack_first_layer_is_exact(relu):
    """9 taps x 3 channels in one 32-wide k-step: the packed weights through
    an im2col product give the plain version's and the JAX reference's bits."""
    cin = 3
    x, k, scale, bias, s_out = _case((2, 12, 10, cin, 32), seed=20 + relu)
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 0, 1, 2)))
    packed = pack_first_layer(w)
    assert packed.shape == (32, 32) and not packed[:, 9 * cin:].any()
    got = _im2col_conv(x, packed.numpy(), scale, bias, s_out, relu)
    ref = np.asarray(conv3x3_int8_reference(x, k, scale, bias, s_out, relu=relu))
    plain = conv3x3_int8_plain(torch.from_numpy(x), w, torch.from_numpy(scale),
                               torch.from_numpy(bias), torch.tensor(s_out), relu).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(plain, ref)


@pytest.mark.parametrize("form", ["natural", "packed"])
@pytest.mark.parametrize("cin", [3, 1, 16, 64, 40, 96])
def test_wrapper_takes_every_weight_form(cin, form):
    """Natural and pack_weights'd weights give the same bits on CPU tensors
    (the plain version unpacks what the kernel reads)."""
    x, k, scale, bias, s_out = _case((1, 9, 7, cin, 48), seed=30 + cin)
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 0, 1, 2)))
    w = {"natural": w, "packed": pack_weights(w, cin)}[form]
    got = conv3x3_int8(torch.from_numpy(x), w, torch.from_numpy(scale),
                       torch.from_numpy(bias), torch.tensor(s_out)).numpy()
    ref = np.asarray(conv3x3_int8_reference(x, k, scale, bias, s_out))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cin", [3, 2, 32, 40, 96])
def test_pack_weights_layout(cin):
    """pack_weights' layout element by element: for Cin = 3,
    [o, t * 3 + i] = w[o, t // 3, t % 3, i]; for any other Cin,
    [k, t, o, i] = w[o, t // 3, t % 3, 16 k + i] (zero past Cin)."""
    cout = 16
    w = torch.from_numpy(np.random.default_rng(cin).integers(
        -127, 128, (cout, 3, 3, cin)).astype(np.int8))
    p = pack_weights(w, cin)
    if cin == 3:
        assert p.shape == (cout, 32)
        for t in range(9):
            for i in range(cin):
                assert torch.equal(p[:, t * cin + i], w[:, t // 3, t % 3, i])
    else:
        cp = cin + -cin % 32
        assert p.shape == (cp // 16, 9, cout, 16) and p.is_contiguous()
        wp = pad_channels(w)
        for t in range(9):
            for c in range(cp):
                assert torch.equal(p[c // 16, t, :, c % 16], wp[:, t // 3, t % 3, c])


@pytest.mark.parametrize("cin,bad_shape", [
    (3, (8, 31)),             # first-layer packing is 32 wide
    (3, (2, 9, 8, 16)),       # Cin = 3 takes pack_first_layer's form, not this one
    (64, (8, 32)),            # a first-layer packing for Cin = 64
    (64, (3, 9, 8, 16)),      # Cin / 16 is 4
    (64, (4, 9, 8, 8)),       # 16-byte rows
    (2, (8, 32)),             # only Cin = 3 packs into one k-step
    (3, (8, 3, 3, 32)),       # natural weights with Cin zero-padded: not a form
    (16, (8, 3, 3, 32)),
])
def test_check_rejects_wrongly_packed_weights(cin, bad_shape):
    x = torch.zeros(1, 4, 4, cin, dtype=torch.int8)
    w = torch.zeros(bad_shape, dtype=torch.int8)
    with pytest.raises(ValueError):
        conv3x3_int8(x, w, torch.ones(8), torch.zeros(8), torch.tensor(1.0))
