"""The BN-folded bf16 conv's one-pass epilogue (ops/kernels/bias_relu.py, the
operator ``torch.ops.tpu_unet_torch.bias_relu_bf16``) and its routing in
``models/blocks.py::DoubleConv``.

On the CPU: the plain version against the blocks' composed route and the
float32 arithmetic written in numpy (NaN, signed zeros, ties at bf16
rounding; the ladder's widths in both memory formats); torch.library.opcheck;
the fake implementation's shapes; the wrapper's checks and its launch
counter; the route each kind of model takes (``blocks.COUNTERS``), with the
fused route forced on the CPU giving the composed route's outputs bit for
bit; a folded bf16 scorer exported as an artifact, with and without the
operator in its program.

On a CUDA card (``-m card``; skipped without one): the kernel against the
plain version bit for bit at every epilogue shape of the bf16 serving cells,
in both layouts and on its scalar path; a served AnomalyUNet at b128 and a
SegmentationUNet at b1 bit for bit the composed route, 18 fused epilogues and
18 launches a forward; a bf16 artifact exported there records the operator
and serves the live engine's scores. This file imports no JAX, so on the
card it runs without the suite's conftest:

    python -m pytest --noconftest -m card tests/test_torch_bias_relu.py
"""

import sys
import threading

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.models import blocks, build_model
from tpu_unet_torch.ops.fold_bn import fold_batchnorm
from tpu_unet_torch.ops.kernels.bias_relu import _OP, bias_relu_bf16, bias_relu_bf16_plain
from tpu_unet_torch.serve import AnomalyScorer, SegmentationPredictor
from tpu_unet_torch.serve_artifact import export_artifact, load_artifact

LADDER_WIDTHS = [64, 128, 256, 512, 1024]
FORMATS = {"channels_last": torch.channels_last, "nchw": torch.contiguous_format}


def make_case(n, c, h, w, seed=0, memory_format=torch.channels_last, device="cpu"):
    """(y, bias): a bf16 conv output and a float32 bias with NaNs, signed
    zeros (in y and in the bias, so -0 + -0 reaches the ReLU) and, in every
    third channel, a bias of an odd multiple of 2^-8 over y in [1, 2), whose
    sums lie exactly halfway between two bf16 values."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn(n, c, h, w, generator=g, device=device)
    bias = torch.randn(c, generator=g, device=device) * 0.5
    ties = torch.arange(0, c, 3, device=device)
    odd = 2 * torch.randint(0, 4, (len(ties),), generator=g, device=device) + 1
    bias[ties] = odd.float() * 2.0 ** -8
    y[:, ties] = 1 + torch.randint(0, 128, (n, len(ties), h, w), generator=g,
                                   device=device).float() * 2.0 ** -7
    zeros = torch.arange(1, c, 3, device=device)
    bias[zeros[::2]] = -0.0
    bias[zeros[1::2]] = 0.0
    pick = torch.rand(n, c, h, w, generator=g, device=device)
    y[pick < 0.01] = float("nan")
    y[(pick >= 0.01) & (pick < 0.06)] = -0.0
    y[(pick >= 0.06) & (pick < 0.08)] = 0.0
    y = y.to(torch.bfloat16).contiguous(memory_format=memory_format)
    return y, bias


def bits(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor's bits, in NCHW order (NaNs compare equal)."""
    return t.contiguous().view(torch.int16)


def numpy_reference(y: torch.Tensor, bias: torch.Tensor):
    """The epilogue from its definition: the float32 sum, a ReLU that keeps
    NaN (the sign of a zero as ``F.relu`` gives it), then round to nearest
    even. Returns (the bf16 bits, where the result is NaN); a NaN's bits
    are the cast's to choose (PyTorch's vectorized and scalar casts differ)."""
    v = y.float().numpy() + bias.numpy()[None, :, None, None]
    r = np.where(v < 0, np.float32(0), v).astype(np.float32)
    zero = r == 0
    r[zero] = F.relu(torch.from_numpy(v[zero])).numpy()
    u = r.view(np.uint32).astype(np.uint64)
    out = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return out.view(np.int16), np.isnan(r)


def _fold(model: nn.Module) -> nn.Module:
    """``model`` in eval mode with seeded BN statistics folded into its convs."""
    g = torch.Generator().manual_seed(7)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    return fold_batchnorm(model.eval())


def _double_conv(c: int) -> blocks.DoubleConv:
    return _fold(blocks.DoubleConv(c, c, policy=get_policy("bf16")))


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("c", LADDER_WIDTHS)
def test_plain_version_is_the_composed_chain_bit_for_bit(c, fmt, monkeypatch):
    """DoubleConv's composed route (conv_bn's float32 bias add, the ReLU and
    the cast) and its fused route (the operator's plain version on the CPU)
    on the same conv output, and both against the numpy definition."""
    y, _ = make_case(2, c, 6, 5, seed=c, memory_format=FORMATS[fmt])
    block = _double_conv(c)
    bias = block.double_conv[3].bias.detach()
    with torch.no_grad():
        bias.copy_(make_case(2, c, 6, 5, seed=c)[1])
    monkeypatch.setattr(blocks, "_conv", lambda conv, x, policy, dtype, *a, **kw: y.to(dtype))
    x = torch.zeros(2, c, 6, 5)
    with torch.no_grad():
        composed = block(x)
        monkeypatch.setattr(blocks, "_on_card", lambda t: True)
        fused = block(x)
    plain = bias_relu_bf16_plain(y, bias)
    assert plain.dtype == torch.bfloat16 and plain.is_contiguous(memory_format=FORMATS[fmt])
    assert torch.equal(bits(plain), bits(composed)) and torch.equal(bits(fused), bits(composed))
    want, nan = numpy_reference(y, bias)
    np.testing.assert_array_equal(plain.contiguous().isnan().numpy(), nan)
    np.testing.assert_array_equal(np.where(nan, 0, bits(plain).numpy()), np.where(nan, 0, want))
    # the case holds what it is for: ties, NaNs, negative zeros out of the ReLU
    v = y.float() + bias.view(-1, 1, 1)
    assert ((v.view(torch.int32) & 0xFFFF) == 0x8000).sum() > 100
    assert plain.isnan().any() and plain.signbit().logical_and(plain == 0).any()


@pytest.mark.parametrize("shape, fmt", [((2, 16, 3, 5), "channels_last"), ((1, 12, 4, 4), "nchw"),
                                        ((3, 8, 1, 1), "channels_last"), ((1, 24, 2, 3), "nchw")])
def test_bias_relu_opcheck(shape, fmt):
    y, bias = make_case(*shape, memory_format=FORMATS[fmt])
    # opcheck compares eager and traced outputs, where NaN equals nothing
    torch.library.opcheck(_OP, (torch.nan_to_num(y), bias))


def test_fake_shapes_equal_the_real_outputs():
    args = make_case(2, 16, 3, 5)
    real = bias_relu_bf16(*args)
    with FakeTensorMode() as mode:
        fake = bias_relu_bf16(*(mode.from_tensor(a) for a in args))
    assert fake.shape == real.shape == (2, 16, 3, 5)
    assert fake.dtype == real.dtype == torch.bfloat16
    assert fake.stride() == real.stride()


def test_wrapper_runs_the_plain_version_on_cpu_counts_no_launch_and_checks():
    before = bias_relu_bf16.launches
    y, bias = make_case(2, 16, 3, 5, seed=3)
    assert torch.equal(bits(bias_relu_bf16(y, bias)), bits(bias_relu_bf16_plain(y, bias)))
    assert bias_relu_bf16.launches == before
    with pytest.raises(TypeError, match="bfloat16 y"):
        bias_relu_bf16(y.float(), bias)
    with pytest.raises(TypeError, match="float32 bias"):
        bias_relu_bf16(y, bias.double())
    with pytest.raises(ValueError, match="bias \\(C,\\)"):
        bias_relu_bf16(y, bias[:8])
    with pytest.raises(ValueError, match="bias \\(C,\\)"):
        bias_relu_bf16(y[0], bias)
    with pytest.raises(ValueError, match="contiguous bias"):
        bias_relu_bf16(y, torch.zeros(32)[::2])
    with pytest.raises(ValueError, match="dense in channels_last or contiguous"):
        bias_relu_bf16(y[:, :, :, ::2], bias)


def _anomaly_model(policy="bf16", seed=0):
    torch.manual_seed(seed)
    return build_model("anomaly_unet", base_features=4, policy=get_policy(policy))


def _folded(policy="bf16"):
    return _fold(_anomaly_model(policy))


def _tensor_parallel():
    """A folded bf16 model whose DoubleConvs are tagged as tensor-parallel
    (conv1 'column', conv2 'row'), as ``parallel/tensor.py::shard_state``
    tags them."""
    model = _folded()
    for m in model.modules():
        if isinstance(m, blocks.DoubleConv):
            for i, tp in ((0, "column"), (3, "row")):
                m.double_conv[i].tp, m.double_conv[i].tp_group = tp, None
    return model


ROUTE_CASES = {
    # name: (model, train mode, grad mode, the fused route's device test patched to True)
    "folded_bf16_on_the_cpu": (_folded, False, False, False),
    "unfolded_train": (_anomaly_model, True, True, True),
    "unfolded_eval": (_anomaly_model, False, False, True),
    "folded_bf16_grad_mode_on": (_folded, False, True, True),
    "folded_f32": (lambda: _folded("f32"), False, False, True),
    "tensor_parallel": (_tensor_parallel, False, False, True),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_every_other_model_takes_the_composed_route(case, monkeypatch):
    """Each case misses the fused route for one reason; the patched device
    test stands in for a card, so the case's own reason is what keeps it
    composed. AnomalyUNet's score path runs 9 DoubleConvs, 18 epilogues."""
    make, train, grad, on_card = ROUTE_CASES[case]
    model = make().train(train)
    if on_card:
        monkeypatch.setattr(blocks, "_on_card", lambda t: True)
    reduced = []
    monkeypatch.setattr(blocks, "reduce_from_model",
                        lambda y, group: reduced.append(y.dtype) or y)
    blocks.COUNTERS.update(fused_epilogues=0, composed_epilogues=0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 32, 32),
                                                                  dtype=np.float32))
    with torch.set_grad_enabled(grad):
        out = model.score_forward(x)
    assert blocks.COUNTERS == {"fused_epilogues": 0, "composed_epilogues": 18}
    assert torch.isfinite(out).all()
    # a row conv's partial sums are reduced in float32, before the bias
    assert reduced == ([torch.float32] * 9 if case == "tensor_parallel" else [])


def test_a_folded_bf16_model_on_the_card_takes_the_fused_route(monkeypatch):
    """The device test patched: the fused route on the CPU (the operator's
    plain version), 18 epilogues, the composed route's outputs bit for bit."""
    model = _folded()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, 32, 32),
                                                                  dtype=np.float32))
    with torch.inference_mode():
        composed = model.score_forward(x)
        monkeypatch.setattr(blocks, "_on_card", lambda t: True)
        blocks.COUNTERS.update(fused_epilogues=0, composed_epilogues=0)
        fused = model.score_forward(x)
    assert blocks.COUNTERS == {"fused_epilogues": 18, "composed_epilogues": 0}
    assert torch.equal(fused, composed)


def test_route_counts_lose_no_update_across_threads():
    """Serving replicas run the blocks on threads of their own."""
    blocks.COUNTERS.update(fused_epilogues=0, composed_epilogues=0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [blocks._count("fused_epilogues")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert blocks.COUNTERS == {"fused_epilogues": 16 * 2000, "composed_epilogues": 0}


def _images(seed, n, hw):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _state_dict(arch, **kw):
    """A seeded state_dict with seeded BN statistics (reference names)."""
    torch.manual_seed(3)
    model = build_model(arch, base_features=4, **kw)
    g = torch.Generator().manual_seed(4)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    return model.state_dict()


@pytest.mark.parametrize("fused", [False, True])
def test_a_folded_bf16_scorer_exports_and_loads_with_its_scores(fused, monkeypatch, tmp_path):
    """On the CPU the program holds the composed ops; with the device test
    patched it records the operator once per epilogue, and the loaded
    program runs its plain version: the scores are the live engine's either
    way, and the same bits on both routes."""
    sd = _state_dict("anomaly_unet")
    images = _images(5, 3, (32, 32))
    plain = AnomalyScorer.from_state_dict(sd, image_size=32, batch_size=2, base_features=4,
                                          device="cpu", precision="bf16").score_array(images)
    if fused:
        monkeypatch.setattr(blocks, "_on_card", lambda t: True)
    live = AnomalyScorer.from_state_dict(sd, image_size=32, batch_size=2, base_features=4,
                                         device="cpu", precision="bf16")
    export_artifact(live, str(tmp_path))
    program = torch.export.load(str(tmp_path / "program_b2.pt2"))
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets.count("tpu_unet_torch.bias_relu_bf16.default") == (18 if fused else 0)
    monkeypatch.undo()
    loaded = load_artifact(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(loaded.score_array(images), live.score_array(images))
    np.testing.assert_array_equal(live.score_array(images), plain)


# The epilogues of the bf16 serving cells, (N, C, H, W): AnomalyUNet's score
# path at b128, 256², and SegmentationUNet's at b1, 1024 x 512 (base 64), one
# per level; the second conv of a block has its first's shape.
SERVING_SHAPES = [(128, 64, 256, 256), (128, 128, 128, 128), (128, 256, 64, 64),
                  (128, 512, 32, 32), (128, 1024, 16, 16),
                  (1, 64, 1024, 512), (1, 128, 512, 256), (1, 256, 256, 128),
                  (1, 512, 128, 64), (1, 1024, 64, 32)]
# Off the serving path, the scalar path: a C (channels_last) or an H * W
# (NCHW) that is not a multiple of 8.
RAGGED_SHAPES = [(2, 12, 5, 7), (3, 20, 3, 3), (1, 3, 9, 11)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("shape", SERVING_SHAPES + RAGGED_SHAPES)
def test_the_kernel_is_the_plain_version_bit_for_bit_on_the_card(shape, fmt):
    _need_card()
    y, bias = make_case(*shape, seed=shape[1] + shape[2], memory_format=FORMATS[fmt],
                        device="cuda")
    before = bias_relu_bf16.launches
    got = bias_relu_bf16(y, bias)
    torch.cuda.synchronize()
    assert bias_relu_bf16.launches == before + 1
    assert got.stride() == y.stride()
    want = bias_relu_bf16_plain(y, bias)
    same = bits(got) == bits(want)
    assert bool(same.all()), f"{int((~same).sum())} values differ"


@pytest.mark.card
def test_an_unaligned_y_takes_the_scalar_path_bit_for_bit():
    _need_card()
    y, bias = make_case(2, 64, 8, 8, seed=9, device="cuda")
    flat = torch.empty(y.numel() + 1, dtype=torch.bfloat16, device="cuda")
    odd = flat[1:].view(2, 8, 8, 64).permute(0, 3, 1, 2)  # 2 bytes past 16-byte alignment
    odd.copy_(y)
    assert odd.is_contiguous(memory_format=torch.channels_last) and odd.data_ptr() % 16
    assert torch.equal(bits(bias_relu_bf16(odd, bias)), bits(bias_relu_bf16_plain(odd, bias)))


def _served(engine_fn, monkeypatch):
    """``engine_fn()``'s outputs on the composed route (the predicate
    patched to refuse) and on the fused route, with the fused forward's
    route counts and kernel launches."""
    with monkeypatch.context() as m:
        m.setattr(blocks, "fuses_epilogue", lambda *a: False)
        composed = engine_fn()
    blocks.COUNTERS.update(fused_epilogues=0, composed_epilogues=0)
    before = bias_relu_bf16.launches
    fused = engine_fn()
    return composed, fused, dict(blocks.COUNTERS), bias_relu_bf16.launches - before


def _full_state_dict(arch, **kw):
    torch.manual_seed(5)
    model = build_model(arch, base_features=64, **kw)
    g = torch.Generator().manual_seed(6)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    return model.state_dict()


@pytest.mark.card
def test_a_served_anomaly_unet_at_b128_is_the_composed_route_bit_for_bit(monkeypatch):
    _need_card()
    scorer = AnomalyScorer.from_state_dict(_full_state_dict("anomaly_unet"), image_size=256,
                                           batch_size=128, precision="bf16", device="cuda")
    images = _images(11, 128, (256, 256))
    composed, fused, counts, launches = _served(lambda: scorer.score_array(images),
                                                monkeypatch)
    assert counts == {"fused_epilogues": 18, "composed_epilogues": 0} and launches == 18
    np.testing.assert_array_equal(fused, composed)


@pytest.mark.card
def test_a_served_seg_unet_at_b1_is_the_composed_route_bit_for_bit(monkeypatch):
    _need_card()
    predictor = SegmentationPredictor.from_state_dict(
        _full_state_dict("seg_unet", n_classes=3), num_classes=3, image_size_hw=(1024, 512),
        batch_size=1, precision="bf16", device="cuda")
    images = _images(12, 2, (1024, 512))
    composed, fused, counts, launches = _served(lambda: predictor.predict_array(images),
                                                monkeypatch)
    assert counts == {"fused_epilogues": 36, "composed_epilogues": 0} and launches == 36
    for a, b in zip(fused, composed):
        np.testing.assert_array_equal(a, b)


@pytest.mark.card
def test_a_bf16_artifact_exported_on_the_card_records_the_operator(tmp_path):
    _need_card()
    live = AnomalyScorer.from_state_dict(_state_dict("anomaly_unet"), image_size=64,
                                         batch_size=2, base_features=4, precision="bf16",
                                         device="cuda")
    export_artifact(live, str(tmp_path))
    program = torch.export.load(str(tmp_path / "program_b2.pt2"))
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets.count("tpu_unet_torch.bias_relu_bf16.default") == 18
    images = _images(13, 3, (64, 64))
    before = bias_relu_bf16.launches
    scores = load_artifact(str(tmp_path), device="cuda").score_array(images)
    assert bias_relu_bf16.launches == before + 2 * 18
    np.testing.assert_array_equal(scores, live.score_array(images))
