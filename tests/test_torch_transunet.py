"""TransUNet (tpu_unet_torch/models/transunet.py) on the CPU in float32 at a
tiny preset (width 32, one unit a stage, hidden 64, 4 heads, 2 blocks, MLP
128, decoder 64-32-16-16, 128 x 64 inputs, whose stage-1 output of 31 x 15
takes the per-side pad), against the benchmark's plain reference
(port_bench/reference/transunet.py): the forward in eval and train mode,
one seg train step with Adam, the parameter counts at the published widths,
the FLOP formulas, the spans and counters, the refusals of the paths it does
not take, and the KolektorSDD trainer with ``--model transunet``."""

import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from port_bench import flops_transunet, inputs
from port_bench.models import transunet as family
from port_bench.reference import augment as ref_augment
from port_bench.reference import losses as ref_losses
from port_bench.reference.adam import Adam
from port_bench.reference.transunet import TransUNetRef
from tpu_unet_torch.models import build_model
from tpu_unet_torch.models import transunet as tu
from tpu_unet_torch.ops.augment import AugmentDraws
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import AugmentConfig, SegLossConfig, make_seg_train_step
from tpu_unet_torch.utils import spans

H, W, C, N = 128, 64, 3, 2
TINY = dict(resnet_units=(1, 1, 1), hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
            decoder_channels=(64, 32, 16, 16))
CONFIG = {"model": "transunet", "base_features": 32, "n_channels": 3, "n_classes": C,
          "resnet_units": [1, 1, 1], "hidden_size": 64, "num_layers": 2,
          "num_heads": 4, "mlp_dim": 128, "decoder_channels": [64, 32, 16, 16],
          "skip_channels": [256, 128, 32, 16], "n_skip": 3, "dropout": 0.1,
          "image_height": H, "image_width": W,
          "loss": {"ce_weight": 1.0, "dice_weight": 1.0, "focal_weight": 0.0,
                   "class_weights": [1.0, 50.0, 50.0]},
          "augment": {"degrees": 20.0, "p_flip": 0.5, "brightness": 0.0, "contrast": 0.0,
                      "saturation": 0.0, "hue": 0.0, "rotation_mode": "per_batch_shear"}}
LR, WD = 1e-4, 1e-4


def _port(**kw):
    return build_model("transunet", n_classes=C, base_features=32, image_size_hw=(H, W),
                       **TINY, **kw)


@pytest.fixture(scope="module")
def pair():
    ref = TransUNetRef(CONFIG)
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
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)
    assert bool(stats) == (mode == "train")
    if mode == "train":  # the dropout did something
        with torch.no_grad():
            plain = ref.forward(p, x, bn="train", keep=[torch.ones_like(k) for k in keep])[0][0]
        assert (plain - want[0]).abs().max() > 1e-2


def test_one_train_step_matches_the_reference(pair):
    _, ref, p = pair
    model = _port()
    model.load_state_dict(p)
    state = create_train_state(model, "adam", LR, WD, device="cpu")
    gen = torch.Generator().manual_seed(5)
    imgs = torch.from_numpy(inputs.images(np.random.default_rng(6), N, H, W))
    labels = torch.from_numpy(inputs.region_map(np.random.default_rng(7), N, H, W,
                                                [0.8, 0.1, 0.1], 16))
    d = inputs.augment_draws(N, CONFIG["augment"], gen)
    packed = family.keep_mask(CONFIG, N, gen)
    aug = AugmentConfig(**CONFIG["augment"])
    step = make_seg_train_step(C, SegLossConfig(class_weights=(1.0, 50.0, 50.0)), aug)
    losses, _ = step.with_draws(state, imgs, labels, AugmentDraws(**d),
                                dropout=family.masks(CONFIG, packed))

    q = {k: v.clone() for k, v in p.items()}
    names = [k for k, _, role in ref.specs() if role not in ("running_mean", "running_var",
                                                               "count")]
    for k in names:
        q[k].requires_grad_(True)
    x, t = ref_augment.paired_augment(imgs, labels[..., None], d, CONFIG["augment"])
    outs, stats = ref.forward(q, x.permute(0, 3, 1, 2), bn="train",
                              keep=family.masks(CONFIG, packed))
    loss = ref_losses.segmentation(outs[0].permute(0, 2, 3, 1), t[..., 0].long(),
                                   CONFIG["loss"])
    grads = dict(zip(names, torch.autograd.grad(loss, [q[k] for k in names])))
    Adam(LR, WD).step({k: q[k] for k in names}, grads)

    assert float(losses["total_loss"]) == pytest.approx(loss.item(), rel=1e-5)
    params = dict(state.model.named_parameters())
    scale = max(float(g.abs().max()) for g in grads.values())
    for k in names:
        # float32 sums in another order through 30 layers: the largest gap
        # reads about 1e-5 of the largest gradient element
        torch.testing.assert_close(params[k].grad, grads[k], rtol=1e-3, atol=1e-4 * scale,
                                   msg=k)
    moved = state.model.state_dict()
    for k in names:
        # Adam's first step moves an element by lr g / (|g| + 1e-8): lr, but
        # where g nears Adam's eps and the two sides' rounding decides it
        sure = (grads[k] + WD * p[k]).abs() > 1e-6
        torch.testing.assert_close((moved[k] - p[k])[sure], (q[k].detach() - p[k])[sure],
                                   rtol=1e-3, atol=1e-3 * LR, msg=k)
    for k, v in stats.items():
        torch.testing.assert_close(moved[k], v, rtol=1e-4, atol=1e-5, msg=k)


@pytest.mark.parametrize("hw,classes,count", [((224, 224), 9, 105_277_081),
                                              ((1024, 512), 3, 106_698_547)],
                         ids=["224-9", "1024x512-3"])
def test_parameter_counts_at_the_published_widths(hw, classes, count):
    with torch.device("meta"):
        model = build_model("transunet", n_classes=classes, image_size_hw=hw)
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("hw", [(128, 64), (96, 80)], ids=["128x64", "96x80"])
def test_flop_formulas_match_the_counter(hw):
    config = {**CONFIG, "image_height": hw[0], "image_width": hw[1]}
    ref = TransUNetRef(config)
    p = inputs.weights(ref.specs(), 1, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.forward(p, torch.zeros(N, 3, *hw))
    assert counter.get_total_flops() == N * flops_transunet.forward_per_image(config)


def test_the_spans_and_counters_of_one_forward(pair):
    model = pair[0]
    spans.clear()
    before = dict(tu.COUNTERS)
    with torch.no_grad(), spans.recording():
        model(torch.zeros(N, 3, H, W))
    names = [s.name for s in spans.recorded()]
    assert sorted(set(names)) == ["transunet.attention", "transunet.decoder",
                                  "transunet.embed", "transunet.encoder", "transunet.hybrid"]
    assert names.count("transunet.attention") == 2
    by_id = {s.id: s for s in spans.recorded()}
    assert all(by_id[s.parent].name == "transunet.encoder"
               for s in spans.recorded() if s.name == "transunet.attention")
    assert tu.COUNTERS["attention_calls"] - before["attention_calls"] == 2
    assert tu.COUNTERS["attention_tokens"] - before["attention_tokens"] == 2 * N * 8 * 4


def test_sample_dropout_draws_every_mask_at_its_rate():
    model = build_model("transunet", n_classes=C, base_features=32, image_size_hw=(H, W),
                        dropout=0.1, **TINY)
    keep = model.sample_dropout(4, torch.Generator().manual_seed(0))
    assert [tuple(k.shape) for k in keep] == model.keep_shapes(4)
    assert len(keep) == 1 + 2 * TINY["num_layers"] and all(k.dtype == torch.bool for k in keep)
    share = float(torch.cat([k.flatten() for k in keep]).float().mean())
    assert share == pytest.approx(0.9, abs=0.01)
    model.train()
    with pytest.raises(ValueError, match="dropout draw"):
        model(torch.zeros(4, 3, H, W))


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
            {}, num_classes=C, model_name="transunet", device="cpu"),
        "int8_plan": lambda: build_plan("transunet"),
        "tensor_parallel": lambda: shard_state(None, create_train_state(_port(), device="cpu")),
        "space_step": space_step,
        "space_flag": lambda: check_model_flags("transunet", n_space=2),
        "model_flag": lambda: check_model_flags("transunet", n_model=2),
        "no_image_size": lambda: build_model("transunet"),
    }


@pytest.mark.parametrize("entry", sorted(_refusals()))
def test_what_does_not_take_a_transunet_raises(entry):
    with pytest.raises(ValueError):
        _refusals()[entry]()


def test_train_kolektorsdd_with_model_transunet(tmp_path, monkeypatch):
    from test_data import make_kolektorsdd
    from tpu_unet_torch.cli import _seg_common as seg
    from tpu_unet_torch.cli import train_kolektorsdd

    def tiny(name, **kw):  # the trainer's model at the tiny preset's widths
        return build_model(name, **kw, **TINY)

    monkeypatch.setattr(seg, "build_model", tiny)
    root = make_kolektorsdd(str(tmp_path / "ksdd"), n_folders=3, per_folder=2)
    out = train_kolektorsdd.main(["--data_root", root, "--model", "transunet", "--epochs", "1",
                                  "--save_dir", str(tmp_path / "out"), "--image_height", "64",
                                  "--image_width", "32", "--base_features", "32",
                                  "--batch_size", "2", "--num_workers", "0", "--device", "cpu",
                                  "--precision", "f32", "--learning_rate", "1e-4"])
    results = (tmp_path / "out").glob("kolektorsdd_transunet_*/results/training_results.json")
    assert out is not None and len(list(results)) == 1
