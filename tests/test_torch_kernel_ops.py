"""K1 and K2 as PyTorch operators (``torch.ops.tpu_unet_torch.normalize_u8``
and ``conv3x3_int8``, ops/kernels/) on the CPU: torch.library.opcheck over
their schema, fake implementations and dispatch; the wrappers keep their
signatures, reach the operators (a torch.export program records them), run
the plain versions on CPU tensors and count no launch there."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tpu_unet_torch.ops.kernels.int8_conv import (_conv3x3_int8_op, conv3x3_int8,
                                                  conv3x3_int8_plain, pack_weights, pad_cout)
from tpu_unet_torch.ops.kernels.preprocess import (_normalize_u8_op, normalize_u8,
                                                   normalize_u8_plain)
from tpu_unet_torch.ops.augment import IMAGENET_MEAN, IMAGENET_STD


def _u8(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


def _conv_case(n, h, w, cin, cout, seed=0, packed=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8))
    k = torch.from_numpy(rng.integers(-127, 128, (cout, 3, 3, cin)).astype(np.int8))
    scale = torch.from_numpy((rng.random(cout) * 1e-3 + 1e-4).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    if packed:
        k, scale, bias = pack_weights(pad_cout(k), cin), pad_cout(scale), pad_cout(bias)
    return x, k, scale, bias, torch.tensor([0.05], dtype=torch.float32)


def test_the_operators_are_registered():
    assert torch.ops.tpu_unet_torch.normalize_u8.default._schema.name == \
        "tpu_unet_torch::normalize_u8"
    assert "ScalarType out_dtype" in str(torch.ops.tpu_unet_torch.normalize_u8.default._schema)
    assert torch.ops.tpu_unet_torch.conv3x3_int8.default._schema.name == \
        "tpu_unet_torch::conv3x3_int8"


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 16, 16, 3)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_normalize_u8_opcheck(shape, out_dtype):
    torch.library.opcheck(_normalize_u8_op,
                          (_u8(shape), list(IMAGENET_MEAN), list(IMAGENET_STD), out_dtype))


@pytest.mark.parametrize("case", [(1, 6, 5, 3, 16, False), (2, 4, 4, 32, 16, False),
                                  (1, 5, 6, 40, 24, True), (1, 4, 3, 3, 12, True)])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_int8_opcheck(case, relu):
    *shape, packed = case
    torch.library.opcheck(_conv3x3_int8_op, (*_conv_case(*shape, packed=packed), relu))


@pytest.mark.parametrize("case", [(1, 6, 5, 3, 16, False), (1, 5, 6, 40, 24, True),
                                  (2, 4, 4, 64, 8, False)])
def test_fake_shapes_equal_the_real_outputs(case):
    *shape, packed = case
    args = _conv_case(*shape, packed=packed)
    real = conv3x3_int8(*args)
    with FakeTensorMode() as mode:
        fake = conv3x3_int8(*(mode.from_tensor(a) for a in args))
        fake_u8 = normalize_u8(mode.from_tensor(_u8((2, 4, 4, 3))), out_dtype=torch.bfloat16)
    assert fake.shape == real.shape and fake.dtype == real.dtype == torch.int8
    assert fake_u8.shape == (2, 4, 4, 3) and fake_u8.dtype == torch.bfloat16


def test_wrappers_run_the_plain_versions_on_cpu_and_count_no_launch():
    k1, k2 = normalize_u8.launches, conv3x3_int8.launches
    x = _u8((2, 8, 8, 3), 1)
    for dt in (torch.float32, torch.bfloat16):
        got = normalize_u8(x, out_dtype=dt)
        want = normalize_u8_plain(x, out_dtype=dt)
        assert got.dtype == dt and torch.equal(got.view(torch.int16 if dt == torch.bfloat16
                                                        else torch.int32),
                                               want.view(torch.int16 if dt == torch.bfloat16
                                                         else torch.int32))
    for packed in (False, True):
        args = _conv_case(2, 6, 6, 32, 16, seed=2, packed=packed)
        assert torch.equal(conv3x3_int8(*args, relu=False),
                           conv3x3_int8_plain(*args, relu=False))
    assert (normalize_u8.launches, conv3x3_int8.launches) == (k1, k2)
    with pytest.raises(TypeError, match="uint8"):
        normalize_u8(x.to(torch.int8))
    with pytest.raises(ValueError, match="scale"):
        x8, w, scale, bias, s = _conv_case(1, 4, 4, 32, 16)
        conv3x3_int8(x8, w, scale[:4], bias, s)


def test_an_exported_program_records_both_operators():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            _, self.w, self.scale, self.bias, self.s = _conv_case(1, 8, 8, 3, 16, seed=3)

        def forward(self, images_u8):
            x = torch.round(normalize_u8(images_u8) * 20).clamp(-127, 127).to(torch.int8)
            return conv3x3_int8(x, self.w, self.scale, self.bias, self.s)

    net = Net()
    images = _u8((2, 8, 8, 3), 4)
    program = torch.export.export(net, (images,), strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert "tpu_unet_torch.normalize_u8.default" in targets
    assert "tpu_unet_torch.conv3x3_int8.default" in targets
    assert torch.equal(program.module()(images), net(images))
