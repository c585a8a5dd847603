"""The port's benchmark entry point (tpu_unet_torch/bench.py) on the CPU at
base 4, 32 px, against the repo's JAX bench.py: the line's keys, its FLOP
accounting against PyTorch's and XLA's counts, the e2e tree and epoch."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch.utils.flop_counter import FlopCounterMode

import bench as jax_bench
from _torch_parity import jax_variables, one_torch_thread, seeded_state_dict  # noqa: F401
from tpu_unet.models import AnomalyUNet as JaxAnomalyUNet
from tpu_unet_torch import bench
from tpu_unet_torch.models import build_model
from tpu_unet_torch.utils import flops

# The keys of the JAX benchmark's line (bench.py:537-570), plus the card.
JAX_LINE_KEYS = [
    "metric", "value", "unit", "median_images_per_sec_per_chip", "vs_baseline",
    "train_e2e_images_per_sec_per_chip", "train_e2e_vs_device_only", "train_e2e",
    "infer_images_per_sec_per_chip", "infer_serving_b128_images_per_sec_per_chip",
    "serve_score_only_b128_images_per_sec_per_chip", "serve_int8_b128_images_per_sec_per_chip",
    "train_per_sample_rotation_images_per_sec_per_chip",
    "train_per_sample_shear_rotation_images_per_sec_per_chip",
    "batch", "image_size", "mfu", "hfu", "hbm_bw_fraction", "step_flops", "fwd_flops",
    "step_hbm_bytes", "peak_flops_bf16", "baseline_configs",
]
JAX_CONFIGS = ["1_unet_focal_256_b16", "2_anomaly_unet_256_b16",
               "3_anomaly_unet_ssim_256_b16", "4_kolektorsdd_1024x512_b8",
               "5_sweep_per_category", "gear_512_b8"]
THROUGHPUTS = [k for k in JAX_LINE_KEYS if k.endswith("images_per_sec_per_chip")]
# 20 PNGs give one epoch of 16 (the batch) with drop_last.
SMALL = ["--device", "cpu", "--base_features", "4", "--image_size", "32",
         "--seg_sizes", "32x16,32x32", "--steps", "2", "--warmup", "1", "--trials", "1",
         "--e2e_images", "20", "--configs", ",".join(bench.CONFIGS)]


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """One small run of every leg and config: (stdout, the returned line,
    the launch counts per leg)."""
    out = io.StringIO()
    cache = str(tmp_path_factory.mktemp("bench_cache"))
    with contextlib.redirect_stdout(out):
        line, legs = bench.main(SMALL + ["--cache_dir", cache])
    return out.getvalue(), line, legs


def test_one_stdout_line_with_the_jax_keys(small_run):
    stdout, line, _ = small_run
    lines = stdout.splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == json.loads(json.dumps(line))
    assert sorted(printed) == sorted(JAX_LINE_KEYS + ["device"]) == sorted(bench.LINE_KEYS)
    assert printed["metric"] == "mvtec_bottle_anomaly_unet_train_images_per_sec_per_chip"
    assert printed["device"] == {"name": "cpu", "nvidia_smi": None}
    assert (printed["batch"], printed["image_size"]) == (16, 32)
    assert printed["hbm_bw_fraction"] is None and printed["step_hbm_bytes"] is None


def test_baseline_configs(small_run):
    configs = small_run[1]["baseline_configs"]
    assert sorted(configs) == sorted(JAX_CONFIGS) == sorted(bench.BASELINE_CONFIGS)
    assert configs["5_sweep_per_category"] == bench.SWEEP_NOTE
    for name in set(JAX_CONFIGS) - {"5_sweep_per_category", "2_anomaly_unet_256_b16"}:
        c = configs[name]
        assert len(c["trial_images_per_sec"]) == 1
        assert 0 < c["mfu"] <= 1 and 0 < c["hfu"] <= 1, (name, c)
    assert configs["2_anomaly_unet_256_b16"]["images_per_sec_per_chip"] == small_run[1]["value"]


@pytest.mark.parametrize("key", THROUGHPUTS + [
    f"baseline_configs.{c}" for c in JAX_CONFIGS if c != "5_sweep_per_category"])
def test_throughput_finite_and_positive(small_run, key):
    line = small_run[1]
    v = (line["baseline_configs"][key.split(".", 1)[1]]["images_per_sec_per_chip"]
         if key.startswith("baseline_configs.") else line[key])
    assert np.isfinite(v) and v > 0, (key, v)


def test_flop_fields(small_run):
    line = small_run[1]
    assert line["fwd_flops"] == flops.forward_flops(4, 32) * 16
    # one train step: about 3x the forward (backward twice), plus the shear products
    assert 2.9 * line["fwd_flops"] < line["step_flops"] < 3.3 * line["fwd_flops"]
    assert 0 < line["mfu"] <= 1 and 0 < line["hfu"] <= 1
    sps = line["value"] / line["batch"]
    assert line["mfu"] == pytest.approx(3 * line["fwd_flops"] * sps / bench.PEAK_FLOPS_BF16,
                                        rel=1e-3)
    assert line["peak_flops_bf16"] == bench.PEAK_FLOPS_BF16
    assert flops.PEAK_FLOPS_BF16 == 989e12 and flops.PEAK_HBM_BPS == 3.35e12


def test_launch_legs_on_the_cpu(small_run):
    """On the CPU the plain versions run: every leg counts no launch, and
    each eval and serving leg records its batches (warm-up included)."""
    legs = small_run[2]
    assert all(v["normalize_u8"] == 0 and v["conv3x3_int8"] == 0 for v in legs.values())
    for leg in ("eval_b16", "eval_b128", "serve_bf16_b128", "serve_int8_b128"):
        assert legs[leg]["batches"] == 3
    assert legs["serve_int8_calibration"]["batches"] == 2


def test_e2e_images_per_epoch(small_run, tmp_path_factory):
    from tpu_unet_torch.data.mvtec import MVTecDataset
    e2e = small_run[1]["train_e2e"]
    root = bench.make_synth_mvtec_tree(str(tmp_path_factory.mktemp("e2e")), 20)
    ds = MVTecDataset(root, "bottle", "train", 32, is_train=True, disk_cache_dir=None)
    assert len(ds) == 20
    assert e2e["images_per_epoch"] == (len(ds) // 16) * 16 == 16
    assert small_run[1]["train_e2e_vs_device_only"] == pytest.approx(
        e2e["images_per_sec_per_chip"] / small_run[1]["value"], abs=1e-3)


# --- (b) the formulas against PyTorch's count of the port's forward ---------------

@pytest.mark.parametrize("name,kw,formula", [
    ("unet", {"n_classes": 1}, lambda: flops.seg_forward_flops(8, 64, 64, 1)),
    ("anomaly_unet", {}, lambda: flops.forward_flops(8, 64)),
    ("seg_unet", {"n_classes": 4}, lambda: flops.seg_forward_flops(8, 64, 64, 4)),
    ("unetpp", {"n_classes": 4, "deep_supervision": True},
     lambda: flops.unetpp_forward_flops(8, 64, 64, 4)),
])
def test_formula_equals_flop_counter(name, kw, formula):
    model = build_model(name, base_features=8, **kw).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(2, 3, 64, 64))
    assert counter.get_total_flops() == 2 * formula()


# --- (c) XLA's count of the JAX forward against the formula -------------------------

def _xla_flops(fn, *args):
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return float(cost["flops"])


def _inside_taps(h, w):
    """The share of a 3x3 SAME conv's taps that land inside an h x w input."""
    return (3 * h - 2) / (3 * h) * (3 * w - 2) / (3 * w)


def _anomaly_unet_inside_tap_flops(base, size):
    """``flops.forward_flops`` with each 3x3 conv counted as XLA counts it:
    the taps inside the input only (the transposed convs and heads as they are)."""
    chans = [base * 2 ** i for i in range(5)]
    conv = lambda cin, cout, h: 2 * 9 * cin * cout * h * h * _inside_taps(h, h)  # noqa: E731
    total = conv(3, base, size) + conv(base, base, size)
    for i in range(1, 5):
        total += conv(chans[i - 1], chans[i], size >> i) + conv(chans[i], chans[i], size >> i)
    for head in (3, 1):
        for i in range(4):
            cin, cout, h = chans[4 - i], chans[3 - i], size >> (3 - i)
            total += 2 * cin * (cin // 2) * h * h + conv(cin, cout, h) + conv(cout, cout, h)
        total += 2 * base * head * size * size
    return total


@pytest.mark.parametrize("base,size,batch", [(16, 64, 2), (64, 256, 1)])
def test_xla_anomaly_unet_forward_near_the_formula(base, size, batch):
    """XLA's count of the JAX forward lies between the formula with only the
    3x3 taps inside the input (below) and the formula: it counts those taps
    and adds elementwise work. 0.924 of the formula at base 16, 64², b2;
    0.980 at base 64, 256², b1."""
    model = JaxAnomalyUNet(base_features=base)
    variables = jax_variables(seeded_state_dict("anomaly_unet", base_features=base),
                              "anomaly_unet")
    x = jnp.zeros((batch, size, size, 3), jnp.float32)
    xla = _xla_flops(lambda v, x: model.apply(v, x, train=False), variables, x)
    formula = flops.forward_flops(base, size) * batch
    inside = _anomaly_unet_inside_tap_flops(base, size) * batch
    assert inside < xla < formula, (inside / formula, xla / formula)
    assert 0.90 <= xla / formula <= 1.00, xla / formula


@pytest.mark.parametrize("h", [64, 16, 4])
def test_xla_counts_a_same_conv_inside_taps_only(h):
    """XLA's count of a 3x3 SAME conv on h x h is the formula's times
    ((3h - 2) / 3h)²: per axis, the border outputs' taps on the zero padding
    are not counted. This is the gap between the two forward counts."""
    cin, cout = 8, 16
    conv = lambda x, w: jax.lax.conv_general_dilated(  # noqa: E731
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xla = _xla_flops(conv, jnp.zeros((1, h, h, cin)), jnp.zeros((3, 3, cin, cout)))
    assert xla == pytest.approx(2 * 9 * h * h * cin * cout * ((3 * h - 2) / (3 * h)) ** 2,
                                rel=1e-9)


# --- (d) the synthetic tree ---------------------------------------------------------

def _pngs(root):
    d = os.path.join(root, "bottle", "train", "good")
    return {f: np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))}


def test_synth_tree_equals_the_jax_benchmarks(tmp_path):
    ours = bench.make_synth_mvtec_tree(str(tmp_path / "port"), n_train=3, src_size=40)
    theirs = jax_bench._make_synth_mvtec_tree(str(tmp_path / "jax"), n_train=3, src_size=40)
    a, b = _pngs(ours), _pngs(theirs)
    assert list(a) == list(b) == ["0000.png", "0001.png", "0002.png"]
    for f in a:
        assert a[f].shape == (40, 40, 3) and a[f].dtype == np.uint8
        np.testing.assert_array_equal(a[f], b[f])
    with open(os.path.join(ours, ".complete")) as f1, \
            open(os.path.join(theirs, ".complete")) as f2:
        assert f1.read() == f2.read()


def test_synth_tree_regenerates_on_a_changed_parameter(tmp_path):
    root = str(tmp_path / "tree")
    bench.make_synth_mvtec_tree(root, n_train=3, src_size=40)
    first = _pngs(root)
    stray = os.path.join(root, "bottle", "train", "good", "stray.png")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(stray)
    bench.make_synth_mvtec_tree(root, n_train=3, src_size=40)  # same: kept as it is
    assert os.path.exists(stray)
    bench.make_synth_mvtec_tree(root, n_train=2, src_size=60)  # changed: rewritten
    second = _pngs(root)
    assert not os.path.exists(stray)
    assert list(second) == ["0000.png", "0001.png"]
    assert second["0000.png"].shape == (60, 60, 3)
    assert not np.array_equal(second["0000.png"][:40, :40], first["0000.png"])
    with open(os.path.join(root, ".complete")) as f:
        assert f.read() == "n_train=2 src=60\n"


# --- (f) no silent fallback -----------------------------------------------------------

def test_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench.main(["--device", "cuda", "--cache_dir", str(tmp_path)])


def test_flags_are_checked():
    with pytest.raises(SystemExit):
        bench.parse_args(["--configs", "1_unet_focal_256_b16,no_such_config"])
    with pytest.raises(SystemExit):
        bench.parse_args(["--seg_sizes", "32x16"])
    with pytest.raises(SystemExit):
        bench.parse_args(["--e2e_images", "8"])  # under one batch of 16
    args = bench.parse_args([])
    assert not hasattr(args, "batch")
    assert (args.image_size, args.steps, args.warmup, args.trials, args.e2e_images,
            args.seg_hw) == (256, 20, 3, 3, 512, [(1024, 512), (512, 512)])
    assert args.configs == list(bench.CONFIGS)
