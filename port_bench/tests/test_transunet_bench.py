"""The TransUNet cell and the bf16 serving cell: their files load as cells,
the TransUNet readers read a hand-made span set joined to a device trace,
and the TransUNet cell runs on the CPU at a tiny preset in float32, correct,
while the control, half a batch and a frozen state come out not correct."""

import io
import json
import time

import pytest
import torch

from port_bench import compare, control, flops_transunet, run, spec
from port_bench.tests.conftest import make_tiny_bench
from port_bench.tests.test_span_metrics import _ctx, _kernel, _launch, _Spans

TRAIN, SERVE = "transunet_kolektorsdd_train_bf16_b16", "anomaly_serve_bf16_b128"
READERS = ("hybrid_ms.transunet_train", "encoder_ms.transunet_train",
           "attention_roofline.transunet_train")
TINY = {"base_features": 32, "resnet_units": [1, 1, 1], "hidden_size": 64, "num_layers": 2,
        "num_heads": 4, "mlp_dim": 128, "decoder_channels": [64, 32, 16, 16],
        "skip_channels": [256, 128, 32, 16], "image_height": 128, "image_width": 64}


def test_the_new_cells_load_from_their_files():
    t, s = spec.load_cell(TRAIN), spec.load_cell(SERVE)
    assert t.config["model"] == "transunet" and t.traffic["batch"] == 16 and t.chips == 1
    assert (t.config["hidden_size"], t.config["num_layers"], t.config["num_heads"],
            t.config["mlp_dim"]) == (768, 12, 12, 3072)
    assert {m["name"] for m in t.end_to_end} == {"train_img_per_s", "setup_s"}
    assert set(READERS) | {"mfu.transunet_train"} <= {m["name"] for m in t.per_layer}
    assert not {"mfu.train", "glue_ms.train"} & {m["name"] for m in t.per_layer}
    assert s.traffic["quantize"] is None and s.traffic["batch"] == 128
    assert {m["name"] for m in s.per_layer} == {"device_idle.serve", "put_ms.serve"}
    assert set(t.traffic["limits"]) == {"loss_gap", "grad_gap_median", "change_gap"}
    assert set(s.traffic["limits"]) == {"score_gap"}


def _step_case():
    """Two kept steps (1000-2000 and 2000-3000 us) whose forwards hold the
    hybrid, the embedding and the encoder with two attention cores, and a
    backward kernel; the window is 990-3000 us."""
    s = _Spans()
    events = [_launch(990, 0)]
    for i, t in enumerate((1000, 2000)):
        r = s.add("train.step", t, t + 900)
        fwd = s.add("train.forward", t + 10, t + 500, parent=r)
        s.add("transunet.hybrid", t + 20, t + 100, parent=fwd)
        s.add("transunet.embed", t + 100, t + 120, parent=fwd)
        enc = s.add("transunet.encoder", t + 120, t + 400, parent=fwd)
        s.add("transunet.attention", t + 150, t + 160, parent=enc)
        s.add("transunet.attention", t + 250, t + 260, parent=enc)
        s.add("train.backward", t + 500, t + 800, parent=r)
        c = 10 * i
        events += [_launch(t + 30, c + 1), _kernel(t + 200, 50, c + 1),    # hybrid
                   _launch(t + 130, c + 2), _kernel(t + 260, 30, c + 2),   # encoder
                   _launch(t + 155, c + 3), _kernel(t + 300, 20, c + 3),   # attention
                   _launch(t + 255, c + 4), _kernel(t + 330, 20, c + 4),   # attention
                   _launch(t + 600, c + 5), _kernel(t + 700, 100, c + 5)]  # backward
    events.append(_launch(2995, 99))
    return events, s.recs


def test_the_transunet_readers_on_a_recorded_span_set(monkeypatch):
    events, recs = _step_case()
    ctx = _ctx(events, recs, monkeypatch, steps=2)
    ctx.config.update(spec.load_cell(TRAIN).config)
    ctx.traffic.update(batch=16)
    got = {m: spec.reader(m)(ctx) for m in READERS}
    assert got["hybrid_ms.transunet_train"] == pytest.approx(0.050)
    assert got["encoder_ms.transunet_train"] == pytest.approx(0.070)
    bound_ms = 1e3 * flops_transunet.attention_bound_s(ctx.config, 16)
    assert got["attention_roofline.transunet_train"] == pytest.approx(100 * bound_ms / 0.040)


@pytest.mark.parametrize("recs", [None, []], ids=["no recorder", "nothing recorded"])
def test_the_transunet_readers_are_none_without_its_spans(monkeypatch, recs):
    events, all_recs = _step_case()
    plain = [r for r in all_recs if not r.name.startswith("transunet.")]
    for r in (recs, plain):
        ctx = _ctx(events, r, monkeypatch, steps=2)
        ctx.config.update(spec.load_cell(TRAIN).config)
        assert {m: spec.reader(m)(ctx) for m in READERS} == dict.fromkeys(READERS)


@pytest.fixture(scope="module")
def tiny_transunet(tmp_path_factory):
    root = make_tiny_bench(tmp_path_factory.mktemp("tiny_transunet"), "f32")
    path = root / "cfg" / "transunet_r50_vit_b16_kolektorsdd_1024x512.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY}))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_transunet_run_is_correct(tiny_transunet, trace):
    out = io.StringIO()
    args = run.parse(["--workload", TRAIN, "--seed", str(2 ** 31 + 77), "--seconds", "0.3",
                      "--trace", str(trace)])
    assert run.run(args, torch.device("cpu"), root=tiny_transunet, t0=time.perf_counter(),
                   out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == ({"mfu.transunet_train"} if trace
                                    else {"train_img_per_s", "setup_s"})


@pytest.mark.parametrize("variant", ["control", "half", "frozen"])
def test_the_transunet_faults_are_not_correct(tiny_transunet, variant):
    cell = spec.load_cell(TRAIN, tiny_transunet)
    numbers = control.readings(cell, 31337, variant, torch.device("cpu"))
    ok, _ = compare.verdict(numbers, cell.traffic["limits"])
    assert not ok, numbers
