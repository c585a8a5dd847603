"""The int8 up block's one-pass concat (ops/kernels/up_concat.py, the
operator ``torch.ops.tpu_unet_torch.up_concat_int8``) and its routing in
``ops/quantize.py::_QuantExec.up_block``.

On the CPU: the plain version against the same float32 arithmetic written
in numpy (ties at .5, saturation at both ends, a strided accumulator);
torch.library.opcheck; the fake implementation's shapes; the wrapper's
checks and its launch counter; an exported int8 program records the
operator; the executor's ``COUNTERS`` (the ladders fused, gated, bilinear,
padded and 'space'-scoped up blocks composed, with the same outputs).

On a CUDA card (``-m card``; skipped without one): the kernel against the
plain version bit for bit at the serving shapes. This file imports no JAX,
so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -m card tests/test_torch_up_concat.py
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops import quantize as tq
from tpu_unet_torch.ops.kernels.up_concat import (_up_concat_int8_op, up_concat_int8,
                                                  up_concat_int8_plain)
from tpu_unet_torch.parallel import spatial
from tpu_unet_torch.serve import SegmentationPredictor
from tpu_unet_torch.serve_artifact import export_artifact


def make_case(n, h, w, cs, cout, seed=0, kind="random", pad_cols=0, device="cpu"):
    """(skip, s_skip, acc, scale, bias, s_cat) of an up block whose level-up
    is (n, h, w) -> (n, 2h, 2w). ``kind`` 'ties': power-of-two scales that
    put every odd value exactly on a .5 tie, and saturation at both ends;
    'random': accumulators of a 1024-channel conv and scales that spread
    the results over [-127, 127] and past it. ``pad_cols`` > 0 gives the
    accumulator as the ``[:m, :4 * cout]`` view of a wider product."""
    g = torch.Generator(device=device).manual_seed(seed)
    m, k = n * h * w, 4 * cout
    skip = torch.randint(-127, 128, (n, 2 * h, 2 * w, cs), generator=g, device=device,
                         dtype=torch.int8)
    if kind == "ties":
        acc = torch.randint(-600, 601, (m, k + pad_cols), generator=g, device=device,
                            dtype=torch.int32)
        scale = torch.full((k,), 0.125, device=device)
        bias = torch.zeros(k, device=device)
        s_skip, s_cat = (torch.tensor(v, device=device) for v in (0.125, 0.25))
    else:
        acc = torch.randint(-2 ** 21, 2 ** 21, (m, k + pad_cols), generator=g, device=device,
                            dtype=torch.int32)
        s_cat = torch.tensor(0.05, device=device)
        per_c = (0.5 + torch.rand(cout, generator=g, device=device)) * (8.0 / 2 ** 21)
        scale = per_c.repeat(4)
        bias = (torch.randn(cout, generator=g, device=device) * 2.0).repeat(4)
        s_skip = 0.02 + 0.08 * torch.rand((), generator=g, device=device)
    return skip, s_skip, acc[:, :k], scale, bias, s_cat


def numpy_reference(skip, s_skip, acc, scale, bias, s_cat):
    """The concat from its definition, in numpy float32, output pixel by
    parity class: out[n, 2i + a, 2j + b, Cs + c] from column (2a + b) Cout + c."""
    skip, acc = skip.numpy(), acc.numpy()
    s_skip, s_cat = np.float32(s_skip.item()), np.float32(s_cat.item())
    n, h2, w2, cs = skip.shape
    cout = acc.shape[1] // 4

    def q(y):
        return np.clip(np.rint(y / s_cat), -127, 127).astype(np.int8)

    out = np.empty((n, h2, w2, cs + cout), np.int8)
    out[..., :cs] = q(skip.astype(np.float32) * s_skip)
    y = acc.astype(np.float32) * scale.numpy()
    y = y + bias.numpy()
    up = q(y).reshape(n, h2 // 2, w2 // 2, 4, cout)
    for a in (0, 1):
        for b in (0, 1):
            out[:, a::2, b::2, cs:] = up[:, :, :, 2 * a + b]
    return out


CPU_CASES = [(2, 3, 4, 16, 8, "ties", 0), (1, 4, 5, 32, 16, "random", 8),
             (2, 2, 3, 24, 40, "random", 3), (1, 5, 2, 64, 16, "ties", 4),
             (1, 1, 1, 8, 4, "random", 0)]


@pytest.mark.parametrize("case", CPU_CASES)
def test_plain_version_is_the_float32_arithmetic_bit_for_bit(case):
    *shape, kind, pad = case
    args = make_case(*shape, seed=sum(shape), kind=kind, pad_cols=pad)
    got = up_concat_int8_plain(*args)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), numpy_reference(*args))
    if kind == "ties":  # the case exercises what it is for
        up = got[..., shape[3]:]
        assert (up == 127).any() and (up == -127).any()
        odd = args[2] % 2 != 0  # acc / 2: exactly k + 0.5
        assert odd.any() and (args[0] % 2 != 0).any()


@pytest.mark.parametrize("case", CPU_CASES[:4])
def test_up_concat_opcheck(case):
    *shape, kind, pad = case
    torch.library.opcheck(_up_concat_int8_op, make_case(*shape, kind=kind, pad_cols=pad))


def test_fake_shapes_equal_the_real_outputs():
    args = make_case(2, 3, 4, 16, 8, pad_cols=8)
    real = up_concat_int8(*args)
    with FakeTensorMode() as mode:
        fake = up_concat_int8(*(mode.from_tensor(a) for a in args))
    assert fake.shape == real.shape == (2, 6, 8, 24)
    assert fake.dtype == real.dtype == torch.int8


def test_wrapper_runs_the_plain_version_on_cpu_counts_no_launch_and_checks():
    before = up_concat_int8.launches
    args = make_case(1, 4, 5, 32, 16, seed=3, pad_cols=8)
    assert torch.equal(up_concat_int8(*args), up_concat_int8_plain(*args))
    assert up_concat_int8.launches == before
    skip, s_skip, acc, scale, bias, s_cat = args
    with pytest.raises(TypeError, match="int8 skip"):
        up_concat_int8(skip.to(torch.int32), s_skip, acc, scale, bias, s_cat)
    with pytest.raises(ValueError, match="accumulator"):
        up_concat_int8(skip, s_skip, acc[:-1], scale, bias, s_cat)
    with pytest.raises(ValueError, match="accumulator"):
        up_concat_int8(skip[:, :-2], s_skip, acc, scale, bias, s_cat)
    with pytest.raises(ValueError, match="skip"):
        up_concat_int8(skip[:, :-1], s_skip, acc, scale, bias, s_cat)
    with pytest.raises(ValueError, match="columns are contiguous"):
        up_concat_int8(skip, s_skip, acc.t().contiguous().t(), scale, bias, s_cat)
    with pytest.raises(ValueError, match="scale"):
        up_concat_int8(skip, s_skip, acc, scale[:4], bias, s_cat)
    with pytest.raises(ValueError, match="s_cat"):
        up_concat_int8(skip, s_skip, acc, scale, bias, torch.ones(2))
    with pytest.raises(ValueError, match="contiguous skip"):
        up_concat_int8(skip.transpose(1, 2).contiguous().transpose(1, 2), s_skip, acc, scale,
                       bias, s_cat)


def _images(seed, n, hw):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _state_dict(arch, seed=0, **kw):
    torch.manual_seed(seed)
    return build_model(arch, base_features=4, **kw).state_dict()


def _qparams(arch, hw=(32, 32), **kw):
    return tq.quantize_from_train_state(arch, _state_dict(arch, **kw), [_images(1, 4, hw)],
                                        device="cpu")


def test_an_exported_int8_program_records_the_operator(tmp_path):
    live = SegmentationPredictor.from_state_dict(
        _state_dict("seg_unet", n_classes=3), num_classes=3, batch_size=2, base_features=4,
        device="cpu", image_size_hw=(32, 32), quantize="int8",
        calib_images=_images(2, 4, (32, 32)))
    export_artifact(live, str(tmp_path))
    program = torch.export.load(str(tmp_path / "program_b2.pt2"))
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets.count("tpu_unet_torch.up_concat_int8.default") == 4


def _routes(arch, images, plan, qparams=None, exchanger=None, **kw):
    """The int8 forward's outputs and the executor's route counts."""
    qparams = qparams or _qparams(arch, images.shape[1:3], **kw)
    tq.COUNTERS.update(fused_up_blocks=0, composed_up_blocks=0)
    with torch.no_grad(), spatial.scope(exchanger, images.shape[1]):
        out = tq._run(tq._QuantExec(qparams), tq.eval_transform(torch.from_numpy(images)),
                      plan)
    return out, dict(tq.COUNTERS)


@pytest.mark.parametrize("arch, kw, hw, plan_kw, want", [
    ("anomaly_unet", {}, (32, 32), {"score_only": True}, (4, 0)),
    ("anomaly_unet", {}, (32, 32), {}, (8, 0)),
    ("seg_unet", {"n_classes": 3}, (32, 16), {}, (4, 0)),
    ("attn_unet", {"n_classes": 3}, (32, 32), {}, (0, 4)),
    ("anomaly_unet", {"bilinear": True}, (32, 32), {"score_only": True}, (0, 4)),
    # 40 -> 20 -> 10 -> 5 -> 2: the deepest level-up (2 -> 4) is padded to 5
    ("seg_unet", {"n_classes": 3}, (40, 40), {}, (3, 1)),
])
def test_up_blocks_take_the_fused_route_where_they_can(arch, kw, hw, plan_kw, want):
    images = _images(5, 2, hw)
    out, counts = _routes(arch, images, tq.build_plan(arch, **plan_kw), **kw)
    assert (counts["fused_up_blocks"], counts["composed_up_blocks"]) == want
    outs = out if isinstance(out, tuple) else (out,)
    assert all(torch.isfinite(o).all() for o in outs)


def test_a_space_scope_composes_and_gives_the_fused_outputs():
    """A one-rank 'space' scope holds every row: the composed route runs
    there and its outputs are the fused route's, bit for bit."""
    images = _images(6, 2, (32, 32))
    qparams = _qparams("seg_unet", n_classes=3)
    plan = tq.build_plan("seg_unet")
    fused, counts = _routes("seg_unet", images, plan, qparams)
    assert counts == {"fused_up_blocks": 4, "composed_up_blocks": 0}
    ring = spatial.ThreadRing(1, timeout=60)
    composed, counts = _routes("seg_unet", images, plan, qparams,
                               exchanger=ring.exchanger(0))
    assert counts == {"fused_up_blocks": 0, "composed_up_blocks": 4}
    assert torch.equal(fused, composed)


def test_route_counts_lose_no_update_across_threads():
    """Serving replicas run the executor on threads of their own."""
    tq.COUNTERS.update(fused_up_blocks=0, composed_up_blocks=0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tq._count("fused_up_blocks")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tq.COUNTERS == {"fused_up_blocks": 16 * 2000, "composed_up_blocks": 0}


# (n, h, w, Cs, Cout) of the level-ups: AnomalyUNet's score path at b128, 256²,
# and SegmentationUNet's at b8, 1024 x 512 (base 64).
SERVING_SHAPES = [(128, 16, 16, 512, 512), (128, 32, 32, 256, 256),
                  (128, 64, 64, 128, 128), (128, 128, 128, 64, 64),
                  (8, 64, 32, 512, 512), (8, 128, 64, 256, 256),
                  (8, 256, 128, 128, 128), (8, 512, 256, 64, 64)]
# Off the serving path: channels that are not multiples of 16 and row strides
# that are not 16-byte aligned take the kernel's scalar path.
ODD_SHAPES = [(2, 3, 5, 24, 40, 3), (1, 7, 9, 16, 16, 1), (3, 4, 4, 64, 32, 8),
              (1, 1, 1, 8, 4, 0)]


@pytest.mark.card
@pytest.mark.parametrize("shape", SERVING_SHAPES + ODD_SHAPES)
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_the_kernel_is_the_plain_version_bit_for_bit_on_the_card(shape, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, h, w, cs, cout, *pad = shape
    args = make_case(n, h, w, cs, cout, seed=h + cs, kind=kind,
                     pad_cols=pad[0] if pad else 8, device="cuda")
    before = up_concat_int8.launches
    got = up_concat_int8(*args)
    torch.cuda.synchronize()
    assert up_concat_int8.launches == before + 1
    want = up_concat_int8_plain(*args)
    assert torch.equal(got, want), f"{int((got != want).sum())} values differ"
