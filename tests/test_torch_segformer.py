"""SegFormer (tpu_unet_torch/models/segformer.py) on the CPU in float32 at a
tiny preset (64 x 64 inputs, widths 8-16-24-32, heads 1-2-3-4, depths
1-1-2-1, reduction ratios 8-4-2-1, a 32 head), against the benchmark's plain
reference (port_bench/reference/segformer.py): the forward in eval and train
mode under given masks, the loss, first gradients and one Adam step through
the seg train step at grad_accum 1 and 2, the masks' draw and their rows per
data rank, the half-pixel upsample, the spans and counters, the refusals of
the paths it does not take, the parameter counts at the published widths,
both seg trainers with ``--model segformer``, and the CUDA graphs' route
(each block captured on aliases of its parameters; the graphed forward
against the eager one under a stand-in for the capture; the step's first
microbatch alone replaying)."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from port_bench import inputs
from port_bench.models import segformer as family
from port_bench.reference import augment as ref_augment
from port_bench.reference import losses as ref_losses
from port_bench.reference.adam import Adam
from port_bench.reference.segformer import SegFormerRef
from tpu_unet_torch.models import build_model
from tpu_unet_torch.models import segformer as sf
from tpu_unet_torch.ops.augment import AugmentDraws
from tpu_unet_torch.ops.resize import upsample_bilinear_half_pixel
from tpu_unet_torch.train import steps
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import AugmentConfig, SegLossConfig, make_seg_train_step
from tpu_unet_torch.utils import spans

H, W, C, N = 64, 64, 3, 4
TINY = dict(embed_dims=(8, 16, 24, 32), num_heads=(1, 2, 3, 4), mlp_ratios=(4, 4, 4, 4),
            depths=(1, 1, 2, 1), sr_ratios=(8, 4, 2, 1), drop_path_rate=0.1, embedding_dim=32)
CONFIG = {"model": "segformer", "n_channels": 3, "n_classes": C, "dropout": 0.1,
          **{k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
          "image_height": H, "image_width": W,
          "loss": {"ce_weight": 1.0, "dice_weight": 1.0, "focal_weight": 0.0,
                   "class_weights": [1.0, 50.0, 50.0]},
          "augment": {"degrees": 5.0, "p_flip": 0.5, "brightness": 0.1, "contrast": 0.1,
                      "saturation": 0.1, "hue": 0.05, "rotation_mode": "per_batch_shear"}}
LR, WD = 1e-3, 1e-4
STATS = ("running_mean", "running_var", "count")


def _port(**kw):
    return build_model("segformer", n_classes=C, **TINY, **kw)


@pytest.fixture(scope="module")
def pair():
    ref = SegFormerRef(CONFIG)
    p = inputs.weights(ref.specs(), 2024, "cpu")
    model = _port()
    model.load_state_dict(p)
    return model, ref, p


def test_the_state_dict_is_the_references(pair):
    model, ref, _ = pair
    sd = model.state_dict()
    assert {k: s for k, s, _ in ref.specs()} == {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_the_reference(pair, mode):
    model, ref, p = pair
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(N, 3, H, W)).astype(np.float32))
    keep = family.masks(CONFIG, family.keep_mask(CONFIG, N, torch.Generator().manual_seed(4)))
    model.train(mode == "train")
    try:
        with torch.no_grad():
            got = model(x, keep)
            want, stats = ref.forward({k: v.clone() for k, v in p.items()}, x, bn=mode,
                                      keep=keep)
    finally:
        model.eval()
    assert got.shape == (N, C, H, W)
    # float32 on both sides; the port's LayerNorms, addcmul residuals and
    # fused attention sum in another order: about 2e-6 of logits near 2
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)
    assert bool(stats) == (mode == "train")
    if mode == "train":  # the masks did something
        with torch.no_grad():
            plain = ref.forward(p, x, bn="train", keep=[torch.ones_like(k) for k in keep])[0][0]
        assert (plain - want[0]).abs().max() > 1e-2


def _reference_step(ref, p, micro):
    """The reference's loss (mean over microbatches), the mean gradient and
    the state after one Adam step and each microbatch's BatchNorm moves;
    ``micro``: (images, labels, draws, packed keep) per microbatch."""
    q = {k: v.clone() for k, v in p.items()}
    names = [k for k, _, role in ref.specs() if role not in STATS]
    for k in names:
        q[k].requires_grad_(True)
    total, grads = 0.0, {k: torch.zeros_like(p[k]) for k in names}
    for imgs, labels, d, packed in micro:
        x, t = ref_augment.paired_augment(imgs, labels[..., None], d, CONFIG["augment"])
        outs, stats = ref.forward(q, x.permute(0, 3, 1, 2), bn="train",
                                  keep=family.masks(CONFIG, packed))
        loss = ref_losses.segmentation(outs[0].permute(0, 2, 3, 1), t[..., 0].long(),
                                       CONFIG["loss"])
        for k, g in zip(names, torch.autograd.grad(loss, [q[k] for k in names])):
            grads[k] += g / len(micro)
        total += loss.item() / len(micro)
        with torch.no_grad():
            for k, v in stats.items():
                q[k].copy_(v)
    Adam(LR, WD).step({k: q[k] for k in names}, grads)
    return total, grads, {k: v.detach() for k, v in q.items()}, names


@pytest.mark.parametrize("accum", [1, 2])
def test_one_train_step_matches_the_reference(pair, accum):
    _, ref, p = pair
    model = _port()
    model.load_state_dict(p)
    state = create_train_state(model, "adam", LR, WD, device="cpu")
    gen = torch.Generator().manual_seed(5)
    imgs = torch.from_numpy(inputs.images(np.random.default_rng(6), N, H, W))
    labels = torch.from_numpy(inputs.region_map(np.random.default_rng(7), N, H, W,
                                                [0.8, 0.1, 0.1], 16))
    m = N // accum
    micro = [(imgs[i * m:(i + 1) * m], labels[i * m:(i + 1) * m],
              inputs.augment_draws(m, CONFIG["augment"], gen),
              family.keep_mask(CONFIG, m, gen)) for i in range(accum)]
    step = make_seg_train_step(C, SegLossConfig(class_weights=(1.0, 50.0, 50.0)),
                               AugmentConfig(**CONFIG["augment"]), grad_accum=accum)
    losses, _ = step.with_draws(state, imgs, labels, [AugmentDraws(**d) for *_, d, _ in micro],
                                dropout=[family.masks(CONFIG, k) for *_, k in micro])
    loss, grads, moved_ref, names = _reference_step(ref, p, micro)

    assert float(losses["total_loss"]) == pytest.approx(loss, rel=1e-5)
    params = dict(state.model.named_parameters())
    scale = max(float(g.abs().max()) for g in grads.values())
    for k in names:
        # float32 sums in another order through 12 layers: the largest gap
        # reads 1.2e-6 to 1.5e-6 of the largest gradient element
        torch.testing.assert_close(params[k].grad, grads[k], rtol=1e-3, atol=1e-4 * scale,
                                   msg=k)
    moved = state.model.state_dict()
    for k in names:
        # Adam's first step moves an element by lr g / (|g| + 1e-8): lr, but
        # where g nears Adam's eps and the two sides' rounding decides it
        sure = (grads[k] + WD * p[k]).abs() > 1e-6
        torch.testing.assert_close((moved[k] - p[k])[sure], (moved_ref[k] - p[k])[sure],
                                   rtol=1e-3, atol=1e-3 * LR, msg=k)
    for k in (k for k, _, role in ref.specs() if role in STATS[:2]):
        # each microbatch moved the running statistics once, in order
        torch.testing.assert_close(moved[k], moved_ref[k], rtol=1e-4, atol=1e-5, msg=k)


def test_each_data_rank_takes_its_rows_of_every_mask(monkeypatch):
    """Under a 2-rank 'data' group the step keeps rank d's rows of each of
    the masks (``train/steps.py::_rows``): the masks of its rows of the
    packed draw."""
    packed = family.keep_mask(CONFIG, 8, torch.Generator().manual_seed(9))
    for d in range(2):
        monkeypatch.setattr(steps.dist, "get_world_size", lambda group: 2)
        monkeypatch.setattr(steps.dist, "get_rank", lambda group, d=d: d)
        got = steps._map_keep(lambda k: steps._rows(k, object(), 4), family.masks(CONFIG, packed))
        want = family.masks(CONFIG, packed[4 * d:4 * d + 4])
        assert [tuple(k.shape) for k in got] == [(4,)] * 8 + [(4, 32)]
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("preset", ["tiny", "b5"])
def test_sample_dropout_draws_every_mask_at_its_rate(preset):
    kw = TINY if preset == "tiny" else {}
    with torch.device("meta"):
        model = build_model("segformer", n_classes=C, **kw)
    n = 4000
    keep = model.sample_dropout(n, torch.Generator().manual_seed(0))
    assert [tuple(k.shape) for k in keep] == model.keep_shapes(n)
    rates = [b.rate for b in model.blocks if b.rate > 0]
    assert len(keep) == 2 * len(rates) + 1 and all(k.dtype == torch.bool for k in keep)
    assert len(rates) == sum(model.backbone.stages()[i][1].__len__() for i in range(4)) - 1
    for k, rate in zip(keep, [r for r in rates for _ in range(2)]):
        assert float(k.float().mean()) == pytest.approx(1 - rate, abs=0.025)
    assert float(keep[-1].float().mean()) == pytest.approx(0.9, abs=0.005)
    model = _port().train()
    with pytest.raises(ValueError, match="dropout draw"):
        model(torch.zeros(2, 3, H, W))


def _half_pixel(x: np.ndarray, f: int) -> np.ndarray:
    """The half-pixel bilinear upsample written out in float64, one axis at a
    time: output i reads the input at (i + 0.5) / f - 0.5, clamped."""
    def axis(a, dim):
        n = a.shape[dim]
        src = np.clip((np.arange(n * f) + 0.5) / f - 0.5, 0, n - 1)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, n - 1)
        wgt = (src - lo).reshape([-1 if i == dim else 1 for i in range(a.ndim)])
        return np.take(a, lo, dim) * (1 - wgt) + np.take(a, hi, dim) * wgt
    return axis(axis(x, 2), 3)


@pytest.mark.parametrize("fmt", ["contiguous", "channels_last"])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_the_half_pixel_upsample_is_interpolates(factor, fmt):
    x = torch.from_numpy(np.random.default_rng(factor).normal(size=(2, 5, 6, 3))
                         .astype(np.float32))
    if fmt == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    got = upsample_bilinear_half_pixel(x, factor)
    want = F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)
    # two float32 products (rows, then columns) against one pass: rounding
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _half_pixel(x.double().numpy(), factor),
                               rtol=1e-6, atol=1e-6)
    assert got.is_contiguous(memory_format=torch.channels_last) == (fmt == "channels_last")
    # the backward sums every output's share into its input in float32
    x.requires_grad_(True)
    g = torch.randn(got.shape)
    (gx,) = torch.autograd.grad((upsample_bilinear_half_pixel(x, factor) * g).sum(), x)
    (want_gx,) = torch.autograd.grad((F.interpolate(x, scale_factor=factor, mode="bilinear",
                                                    align_corners=False) * g).sum(), x)
    torch.testing.assert_close(gx, want_gx, rtol=1e-5, atol=1e-5)
    assert upsample_bilinear_half_pixel(x, 1) is x


def test_the_spans_and_counters_of_one_forward(pair):
    model = pair[0]
    spans.clear()
    before = dict(sf.COUNTERS)
    with torch.no_grad(), spans.recording():
        model(torch.zeros(N, 3, H, W))
    names = [s.name for s in spans.recorded()]
    assert sorted(set(names)) == ["segformer.attention", "segformer.decoder",
                                  "segformer.dwconv", "segformer.encoder"]
    assert names.count("segformer.attention") == names.count("segformer.dwconv") == 5
    by_id = {s.id: s for s in spans.recorded()}
    assert all(by_id[s.parent].name == "segformer.encoder"
               for s in spans.recorded() if s.name in ("segformer.attention", "segformer.dwconv"))
    # queries 16x16, 8x8, 4x4 (twice), 2x2; keys 2x2, 2x2, 2x2 (twice), 2x2
    assert sf.COUNTERS["attention_calls"] - before["attention_calls"] == 5
    assert sf.COUNTERS["query_tokens"] - before["query_tokens"] == N * (256 + 64 + 32 + 4)
    assert sf.COUNTERS["key_tokens"] - before["key_tokens"] == N * 5 * 4


def _refusals():
    from tpu_unet_torch.models.unet import check_model_flags
    from tpu_unet_torch.ops.fold_bn import fold_batchnorm
    from tpu_unet_torch.ops.quantize import build_plan
    from tpu_unet_torch.parallel.tensor import shard_state
    from tpu_unet_torch.serve import SegmentationPredictor

    def space_step():
        state = create_train_state(_port(), "adam", LR, WD, device="cpu")
        step = make_seg_train_step(C, space=types.SimpleNamespace(size=1))
        imgs = torch.zeros(N, H, W, 3, dtype=torch.uint8)
        step(state, imgs, torch.zeros(N, H, W, dtype=torch.uint8), torch.Generator())

    return {
        "fold_bn": lambda: fold_batchnorm(_port()),
        "seg_predictor": lambda: SegmentationPredictor.from_state_dict(
            {}, num_classes=C, model_name="segformer", device="cpu"),
        "int8_plan": lambda: build_plan("segformer"),
        "tensor_parallel": lambda: shard_state(None, create_train_state(_port(), device="cpu")),
        "space_step": space_step,
        "space_flag": lambda: check_model_flags("segformer", n_space=2),
        "model_flag": lambda: check_model_flags("segformer", n_model=2),
        "odd_size": lambda: _port()(torch.zeros(1, 3, 48, 64)),
    }


@pytest.mark.parametrize("entry", sorted(_refusals()))
def test_what_does_not_take_a_segformer_raises(entry):
    with pytest.raises(ValueError):
        _refusals()[entry]()


@pytest.mark.parametrize("classes,count,encoder", [(3, 84_595_651, 81_443_008),
                                                   (150, 84_708_694, 81_443_008)])
def test_parameter_counts_at_the_published_widths(classes, count, encoder):
    with torch.device("meta"):
        model = build_model("segformer", n_classes=classes)
    assert sum(p.numel() for p in model.parameters()) == count
    assert sum(p.numel() for p in model.backbone.parameters()) == encoder
    assert [len(b) for _, b, _ in model.backbone.stages()] == [3, 6, 40, 3]


@pytest.mark.parametrize("cli", ["train_kolektorsdd", "train_gear"])
def test_the_seg_trainers_with_model_segformer(tmp_path, monkeypatch, cli):
    import importlib

    from test_data import make_gear, make_kolektorsdd
    from tpu_unet_torch.cli import _seg_common as seg

    def tiny(name, **kw):  # the trainer's model at the tiny preset's widths
        return build_model(name, **kw, **TINY)

    monkeypatch.setattr(seg, "build_model", tiny)
    if cli == "train_kolektorsdd":
        root = make_kolektorsdd(str(tmp_path / "data"), n_folders=3, per_folder=2)
        size = ["--image_height", "64", "--image_width", "32"]
    else:
        root = make_gear(str(tmp_path / "data"), n_per_split=2, size=32)
        size = ["--image_size", "32"]
    out = importlib.import_module(f"tpu_unet_torch.cli.{cli}").main(
        ["--data_root", root, "--model", "segformer", "--epochs", "1", "--save_freq", "1",
         "--save_dir", str(tmp_path / "out"), *size, "--batch_size", "2",
         "--num_workers", "0", "--device", "cpu", "--precision", "f32",
         "--learning_rate", "6e-5"])
    assert out is not None
    ckpts = list((tmp_path / "out").glob("*_segformer_*/checkpoints/checkpoint_epoch_0.pth"))
    assert len(ckpts) == 1
    sd = torch.load(ckpts[0], map_location="cpu", weights_only=False)
    names = sd.get("model_state_dict", sd)
    assert any(k.startswith("backbone.block3.1.attn.kv") for k in names)


def test_a_graphed_part_is_the_block_on_aliases_of_its_parameters(pair):
    """What the CUDA path captures: each stage's blocks as a function of its
    stream, its (N, 2 k) scales and aliases of its parameters (other
    leaves, the same memory) computes the blocks, and its gradients reach
    the aliases alone."""
    model = pair[0]
    for (_, blocks, _), (h, w) in zip(model.backbone.stages(), model._stage_sizes(H, W)):
        t = torch.randn(2, h * w, blocks[0].norm1.normalized_shape[0])
        scales = torch.rand(2, 2 * sum(b.rate > 0 for b in blocks))
        run = sf._capturable(blocks, h, w, torch.float32)
        aliases = tuple(p.detach().requires_grad_() for p in blocks.parameters())
        assert all(a.data_ptr() == p.data_ptr() for a, p in zip(aliases, blocks.parameters()))
        got = run(t, scales, *aliases)
        want, c = t, 0
        for block in blocks:
            pair_ = ()
            if block.rate > 0:
                pair_, c = (scales[:, c, None, None], scales[:, c + 1, None, None]), c + 2
            want = block(want, pair_, h=h, w=w, cd=torch.float32)
        assert torch.equal(got, want)
        grads = torch.autograd.grad(got.sum(), aliases)
        assert all(g is not None for g in grads)
        assert all(p.grad is None for p in blocks.parameters())


def test_the_graphed_route_is_the_eager_one(pair, monkeypatch):
    """The training forward's graphed route, with ``make_graphed_callables``
    standing in as a check of each call against the sample arguments the
    block was captured on (shapes; which want gradients): its logits and
    gradients are the eager route's, a shape is captured once and another
    shape replaces it, and the counters count each block's forward."""
    captures = []

    def fake(fns, samples, **_):
        captures.append(len(fns))

        def checked(fn, sample):
            def call(*args):
                assert [a.shape for a in args] == [a.shape for a in sample]
                assert [a.requires_grad for a in args] == [a.requires_grad for a in sample]
                return fn(*args)
            return call
        return tuple(checked(f, s) for f, s in zip(fns, samples))

    graphs = [False]
    monkeypatch.setattr(torch.cuda, "make_graphed_callables", fake)
    monkeypatch.setattr(sf.SegFormer, "_graphs_apply", lambda self, x: graphs[0])
    model = _port()
    model.load_state_dict(pair[2])
    model.train()
    x = torch.randn(N, 3, H, W)
    keep = model.sample_dropout(N, torch.Generator().manual_seed(3))
    runs = []
    for graphs[0] in (False, True, True):
        before = sf.COUNTERS["attention_calls"]
        model.zero_grad(set_to_none=True)
        out = model(x, keep)
        out.square().mean().backward()
        assert sf.COUNTERS["attention_calls"] - before == len(model.blocks)
        runs.append((out.detach(), {k: p.grad for k, p in model.named_parameters()}))
    assert captures == [len(model.backbone.stages())]
    for out, grads in runs[1:]:
        assert torch.equal(out, runs[0][0])
        assert all(torch.equal(g, runs[0][1][k]) for k, g in grads.items())
    model(x[:2], tuple(k[:2] for k in keep))
    assert captures == [len(model.backbone.stages())] * 2


def test_graphs_apply_only_inside_graph_replay():
    """A forward replays the blocks' graphs only in training, recording
    autograd, on CUDA and inside the step's ``graph_replay``: a forward
    outside the step (gradients left in place) takes the eager route."""
    from tpu_unet_torch.models import blocks

    model = _port().train()
    card, host = types.SimpleNamespace(is_cuda=True), types.SimpleNamespace(is_cuda=False)
    assert not model._graphs_apply(card)
    with blocks.graph_replay():
        assert model._graphs_apply(card) and not model._graphs_apply(host)
        with torch.no_grad():
            assert not model._graphs_apply(card)
        assert not model.eval()._graphs_apply(card)
    assert not blocks.replaying_graphs()


@pytest.mark.parametrize("accum,remat,want", [(1, "none", [True]), (2, "none", [True, False]),
                                              (1, "full", [False, False])])
def test_the_step_lets_its_first_microbatch_alone_replay_graphs(monkeypatch, accum, remat, want):
    """The seg step opens ``graph_replay`` around its first microbatch's
    forward only, and not where it recomputes (the forward and its recompute
    in the backward both run eagerly): a second microbatch accumulates into
    the gradients the first one's graphs handed out, so it runs eagerly."""
    from tpu_unet_torch.models import blocks

    seen, forward = [], sf.SegFormer.forward

    def spy(self, x, keep=None):
        seen.append(blocks.replaying_graphs())
        return forward(self, x, keep)

    monkeypatch.setattr(sf.SegFormer, "forward", spy)
    state = create_train_state(_port(), "adam", LR, WD, device="cpu")
    step = make_seg_train_step(C, grad_accum=accum, remat=remat)
    step(state, torch.zeros(N, H, W, 3, dtype=torch.uint8),
         torch.zeros(N, H, W, dtype=torch.uint8), torch.Generator().manual_seed(1))
    assert seen == want
