"""The SegFormer cell and the seg int8 serving cell: their files load as
cells; the FLOP formula equals torch's count over the reference; the
family's packed draw splits as the model orders its masks; the SegFormer
readers read a hand-made span set joined to a device trace, with the
attention and dwconv spans of an eager forward or without them (graphed
blocks), and read nothing without the model's spans; the SegFormer cell runs on the CPU at a tiny preset in
float32, correct, while the control, half a batch and a frozen state come out
not correct; the int8 seg cell runs correct at a tiny size."""

import io
import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import compare, control, flops_segformer, inputs, run, spec
from port_bench.models import segformer as family
from port_bench.reference.segformer import SegFormerRef
from port_bench.tests.conftest import make_tiny_bench
from port_bench.tests.test_span_metrics import _ctx, _kernel, _launch, _Spans

TRAIN, SERVE = "segformer_kolektorsdd_train_bf16_b16", "kolektorsdd_serve_int8_b8"
READERS = ("encoder_ms.segformer_train", "decoder_ms.segformer_train",
           "dwconv_ms.segformer_train", "attention_roofline.segformer_train")
TINY = {"embed_dims": [8, 16, 24, 32], "num_heads": [1, 2, 3, 4], "depths": [1, 1, 2, 1],
        "embedding_dim": 32, "image_height": 64, "image_width": 32}


def test_the_new_cells_load_from_their_files():
    t, s = spec.load_cell(TRAIN), spec.load_cell(SERVE)
    assert t.config["model"] == "segformer" and t.traffic["batch"] == 16 and t.chips == 1
    assert (t.config["embed_dims"], t.config["num_heads"], t.config["depths"],
            t.config["sr_ratios"], t.config["embedding_dim"]) == \
        ([64, 128, 320, 512], [1, 2, 5, 8], [3, 6, 40, 3], [8, 4, 2, 1], 768)
    assert {m["name"] for m in t.end_to_end} == {"train_img_per_s", "setup_s"}
    assert set(READERS) | {"mfu.segformer_train", "forward_ms.train", "device_idle.train"} \
        <= {m["name"] for m in t.per_layer}
    assert not {"mfu.train", "glue_ms.train", "mfu.transunet_train"} & \
        {m["name"] for m in t.per_layer}
    assert s.config["model"] == "seg_unet" and s.traffic["quantize"] == "int8"
    assert s.traffic["batch"] == 8 and s.traffic["checked_rows"] == 2
    assert {m["name"] for m in s.end_to_end} == {"serve_img_per_s", "setup_s"}
    assert {m["name"] for m in s.per_layer} == {"device_idle.serve", "put_ms.serve",
                                                "int8_glue_ms.serve", "k2_roofline.serve",
                                                "mfu.serve"}
    assert set(t.traffic["limits"]) == {"loss_gap", "grad_gap_median", "change_gap"}
    assert set(s.traffic["limits"]) == {"logit_gap"}


def test_the_flop_formula_is_the_published_shape_and_the_counter():
    cell = spec.load_cell(TRAIN)
    assert flops_segformer.forward_per_image(cell.config) == 479_176_163_328
    config = {**cell.config, **TINY}
    ref = SegFormerRef(config)
    p = inputs.weights(ref.specs(), 1, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.forward(p, torch.zeros(2, 3, 64, 32))
    assert counter.get_total_flops() == 2 * flops_segformer.forward_per_image(config)


def test_the_packed_draw_splits_as_the_model_orders_its_masks():
    from tpu_unet_torch.models import build_model

    config = spec.load_cell(TRAIN).config
    with torch.device("meta"):
        model = build_model("segformer", **family.model_kwargs(config))
    packed = family.keep_mask(config, 5, torch.Generator().manual_seed(3))
    assert packed.shape == (5, 102 + 768) and packed.dtype == torch.float32
    keep = family.masks(config, packed)
    assert [tuple(k.shape) for k in keep] == model.keep_shapes(5)
    assert torch.equal(torch.stack(keep[:102], 1), packed[:, :102] >= torch.tensor(
        [r for r in model._rates()[:102]]))
    assert torch.equal(keep[-1], packed[:, 102:] >= 0.1)
    # the program draws the same way from the same generator state
    own = model.sample_dropout(5, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(own, keep))


FLASH, DW = "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64>>", \
    "void fprop2d_c1_k1_nhwc_kernel<__nv_bfloat16>"


def _step_case(graphed=False):
    """Two kept steps (1000-2000 and 2000-3000 us) whose forwards hold the
    encoder with two attention cores and one depthwise conv (in their spans,
    or with ``graphed`` in none: a graph's replay), and the decoder; a
    backward kernel of each name; the window is 990-3000 us."""
    s = _Spans()
    events = [_launch(990, 0)]
    for i, t in enumerate((1000, 2000)):
        r = s.add("train.step", t, t + 900)
        fwd = s.add("train.forward", t + 10, t + 500, parent=r)
        enc = s.add("segformer.encoder", t + 20, t + 400, parent=fwd)
        if not graphed:
            s.add("segformer.attention", t + 150, t + 160, parent=enc)
            s.add("segformer.dwconv", t + 200, t + 210, parent=enc)
            s.add("segformer.attention", t + 250, t + 260, parent=enc)
        s.add("segformer.decoder", t + 400, t + 480, parent=fwd)
        s.add("train.backward", t + 500, t + 800, parent=r)
        c = 10 * i
        events += [_launch(t + 30, c + 1), _kernel(t + 200, 50, c + 1),              # encoder
                   _launch(t + 155, c + 3), _kernel(t + 300, 20, c + 3, name=FLASH),  # attention
                   _launch(t + 205, c + 2), _kernel(t + 280, 10, c + 2, name=DW),     # dwconv
                   _launch(t + 255, c + 4), _kernel(t + 330, 20, c + 4, name=FLASH),  # attention
                   _launch(t + 410, c + 6), _kernel(t + 450, 40, c + 6),              # decoder
                   _launch(t + 600, c + 5), _kernel(t + 700, 100, c + 5),             # backward
                   _launch(t + 610, c + 7), _kernel(t + 810, 30, c + 7, name=FLASH),
                   _launch(t + 620, c + 8), _kernel(t + 840, 30, c + 8, name=DW)]
    events.append(_launch(2995, 99))
    return events, s.recs


def _readings(monkeypatch, graphed):
    events, recs = _step_case(graphed)
    ctx = _ctx(events, recs, monkeypatch, steps=2)
    ctx.config.update(spec.load_cell(TRAIN).config)
    ctx.traffic.update(batch=16)
    return ctx, {m: spec.reader(m)(ctx) for m in READERS}


def test_the_segformer_readers_on_a_recorded_span_set(monkeypatch):
    ctx, got = _readings(monkeypatch, graphed=False)
    assert got["encoder_ms.segformer_train"] == pytest.approx(0.100)
    assert got["dwconv_ms.segformer_train"] == pytest.approx(0.010)
    assert got["decoder_ms.segformer_train"] == pytest.approx(0.040)
    bound_ms = 1e3 * flops_segformer.attention_bound_s(ctx.config, 16)
    assert got["attention_roofline.segformer_train"] == pytest.approx(100 * bound_ms / 0.040)


def test_the_segformer_readers_read_graphed_blocks_by_kernel_name(monkeypatch):
    """A replayed block records no attention or dwconv span: the readers
    take the cores' and the depthwise convs' kernels by name within the
    encoder's forward, and read what they read with the spans."""
    assert _readings(monkeypatch, graphed=True)[1] == _readings(monkeypatch, graphed=False)[1]


def test_the_segformer_readers_are_none_without_its_spans(monkeypatch):
    events, all_recs = _step_case()
    plain = [r for r in all_recs if not r.name.startswith("segformer.")]
    for r in (None, plain):
        ctx = _ctx(events, r, monkeypatch, steps=2)
        ctx.config.update(spec.load_cell(TRAIN).config)
        assert {m: spec.reader(m)(ctx) for m in READERS} == dict.fromkeys(READERS)


@pytest.fixture(scope="module")
def tiny_segformer(tmp_path_factory):
    root = make_tiny_bench(tmp_path_factory.mktemp("tiny_segformer"), "f32")
    path = root / "cfg" / "segformer_mit_b5_kolektorsdd_1024x512.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY}))
    return root


def _run(root, workload, trace):
    out = io.StringIO()
    args = run.parse(["--workload", workload, "--seed", str(2 ** 31 + 91), "--seconds", "0.3",
                      "--trace", str(trace)])
    assert run.run(args, torch.device("cpu"), root=root, t0=time.perf_counter(),
                   out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_segformer_run_is_correct(tiny_segformer, trace):
    line = _run(tiny_segformer, TRAIN, trace)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == ({"mfu.segformer_train"} if trace
                                    else {"train_img_per_s", "setup_s"})


def test_a_tiny_int8_seg_run_is_correct(tiny_segformer):
    line = _run(tiny_segformer, SERVE, 0)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"serve_img_per_s", "setup_s"}


@pytest.mark.parametrize("variant", ["control", "half", "frozen"])
def test_the_segformer_faults_are_not_correct(tiny_segformer, variant):
    cell = spec.load_cell(TRAIN, tiny_segformer)
    numbers = control.readings(cell, 31337, variant, torch.device("cpu"))
    ok, _ = compare.verdict(numbers, cell.traffic["limits"])
    assert not ok, numbers


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


@pytest.mark.card
def test_the_bf16_forward_at_b5_widths_on_the_card():
    """One 1024x512 image through the port's bf16 SegFormer-B5 in eval mode,
    against the float32 reference (TF32 off) on the same seeded weights. The
    port's gap is held to three times the gap of the reference itself with
    every conv, linear and attention product rounded to bf16 (its ``lowp``),
    the rounding the port's precision policy makes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from port_bench import reference
    from port_bench.program import _model

    config = spec.load_cell(TRAIN).config
    dev = torch.device("cuda", 0)
    ref = SegFormerRef(config)
    p = inputs.weights(ref.specs(), 2 ** 31 + 5, dev)
    model = _model(config, "bf16")
    model.load_state_dict({k: v.clone() for k, v in p.items()}, assign=True)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    img = inputs.images(inputs.host_rng(11, inputs.STREAM_IMAGES), 1, 1024, 512)
    x = torch.from_numpy(img).to(dev).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        got = model(x.contiguous(memory_format=torch.channels_last))
        with reference.exact_float32():
            want = ref.forward(p, x.contiguous())[0][0]
            rounded = ref.forward(p, x.contiguous(), lowp=_bf16)[0][0]
    assert got.shape == want.shape == (1, 3, 1024, 512) and got.dtype == torch.float32
    gap, floor = float((got - want).abs().max()), float((rounded - want).abs().max())
    print(f"bf16 port {gap:.4g}, bf16-rounded reference {floor:.4g}, "
          f"logits up to {float(want.abs().max()):.4g}")
    assert 0 < gap <= 3 * floor
    assert float((got.argmax(1) == want.argmax(1)).float().mean()) > 0.99


@pytest.mark.card
def test_the_graphed_train_step_is_the_eager_one_on_the_card(monkeypatch):
    """Three train steps of SegFormer-B5 at 256x128, b2, with every block
    replayed as a CUDA graph, and twice eagerly (``_graphs_apply`` patched
    off), from the same weights, batches and draws: the graphed run lies as
    close to the eager one as two eager runs lie to each other (flash
    attention's backward sums its dq with atomics). After the first step,
    which captures, a graphed step runs no block's attention or dwconv span
    (a replay runs no Python); an eager step runs 52 of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from port_bench import cells
    from port_bench.program import TrainProgram
    from tpu_unet_torch.models.segformer import SegFormer
    from tpu_unet_torch.utils import spans

    config = {**spec.load_cell(TRAIN).config, "image_height": 256, "image_width": 128}
    traffic = {**spec.load_cell(TRAIN).traffic, "batch": 2}
    c = cells.make(config, traffic, 2 ** 31 + 17, torch.device("cuda", 0))
    runs = []
    for graphs in (True, False, False):
        if not graphs:
            monkeypatch.setattr(SegFormer, "_graphs_apply", lambda self, x: False)
        prog = TrainProgram(config, c.weights, c.device)
        losses = [prog(*c.pool[0], *c.first[0])]
        spans.clear()
        with spans.recording():
            losses += [prog(*c.pool[i], *c.first[i]) for i in (1, 2)]
        names = [s.name for s in spans.recorded()]
        want = 0 if graphs else 2 * 52
        assert names.count("segformer.attention") == names.count("segformer.dwconv") == want
        assert (prog.state.model._graphs is not None) == graphs
        runs.append((torch.stack(losses), prog.tensors()))

    def gap(a, b):
        return max([float((a[0] - b[0]).abs().max())] +
                   [float((a[1][k] - b[1][k]).abs().max()) for k in a[1]])

    graphed, eager = gap(runs[0], runs[1]), gap(runs[1], runs[2])
    print(f"graphed against eager {graphed:.3g}, eager against eager {eager:.3g}")
    assert graphed <= 2 * eager + 1e-6
