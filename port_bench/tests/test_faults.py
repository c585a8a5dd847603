"""A run whose timed path is broken underneath comes out not correct: a
train step that leaves its state unchanged, one that takes half of its
batch (the mean over the rest), and a serving answer altered where it is
produced. The runs skip the look for a card and run the rest of a run on
the CPU at a tiny size, in float32, where the sound program agrees with
the reference to rounding (so the sound runs come out correct under the
same limits)."""

import copy
import io
import json
import time

import numpy as np
import pytest
import torch

from port_bench import program, run


def _run(root, workload) -> dict:
    out = io.StringIO()
    args = run.parse(["--workload", workload, "--seed", "424242", "--seconds", "0.3"])
    assert run.run(args, torch.device("cpu"), root=root, t0=time.perf_counter(), out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


TRAIN = ["anomaly_train_bf16_b16", "kolektorsdd_train_bf16_b8"]
SERVE = ["anomaly_serve_int8_b128", "kolektorsdd_serve_bf16_b1"]


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_sound_runs_are_correct(tiny_f32, workload):
    assert _run(tiny_f32, workload)["correct"] is True


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_leaves_its_state_unchanged(tiny_f32, workload, monkeypatch):
    call = program.TrainProgram.__call__

    def unchanged(self, *args):
        model = copy.deepcopy(self.state.model.state_dict())
        opt = copy.deepcopy(self.state.optimizer.state_dict())
        loss = call(self, *args)
        self.state.model.load_state_dict(model)
        self.state.optimizer.load_state_dict(opt)
        return loss

    monkeypatch.setattr(program.TrainProgram, "__call__", unchanged)
    assert _run(tiny_f32, workload)["correct"] is False


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_on_half_of_its_batch(tiny_f32, workload, monkeypatch):
    call = program.TrainProgram.__call__

    def half(self, images, targets, draws, keep):
        m = len(images) // 2
        draws = {k: (v if v.dim() == 0 else v[:m]) for k, v in draws.items()}
        return call(self, images[:m], targets[:m], draws, None if keep is None else keep[:m])

    monkeypatch.setattr(program.TrainProgram, "__call__", half)
    assert _run(tiny_f32, workload)["correct"] is False


@pytest.mark.parametrize("workload", SERVE)
def test_an_answer_altered_where_it_is_produced(tiny_f32, workload, monkeypatch):
    engine = program.serving_engine

    def altered(*args, **kwargs):
        e, serve = engine(*args, **kwargs)

        def wrong(batch):
            out = serve(batch)
            if isinstance(out, tuple):  # every pixel's class one on
                return (out[0] + 1) % 3, out[1]
            return out * np.float32(1.01)

        return e, wrong

    monkeypatch.setattr(program, "serving_engine", altered)
    assert _run(tiny_f32, workload)["correct"] is False
