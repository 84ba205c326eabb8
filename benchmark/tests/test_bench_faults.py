"""The check fails what it must. Each test skips the harness's look for a
card and drives the rest of a run on the CPU at a small size (the
published widths kept), with the timed path broken underneath, and sees
``correct`` come out false; a sound run beside it comes out true. The
control, the reference computed in fp8 in the program's place, fails too
(on the card the same readings are taken at each cell's own size by
``benchmark/control.py``)."""

import json
import time

import pytest
import torch

from benchmark import check, control, harness

from conftest import SMALL, SMALL_PARAMS, root_of, small_run

TRAINING = ["xdeepfm-criteo.train-zipf", "deepfm-criteo.train-zipf", "deepfm-criteo.train-uniform",
            "xdeepfm-criteo.train-tsv"]
SERVING = "xdeepfm-criteo.serve-poisson"


@pytest.mark.parametrize("cell", TRAINING + [SERVING])
def test_a_sound_run_is_correct(cell):
    assert small_run(cell)["correct"] is True


def unchanged_state(monkeypatch):
    from recmodels_tpu_torch.train.engine import Engine

    monkeypatch.setattr(Engine, "_apply", lambda self, state, g_dense, plan, g_rows: None)


def half_batch(monkeypatch):
    from recmodels_tpu_torch.train.engine import Engine

    grads = Engine._grads

    def first_half(self, state, dense, ids, labels):
        h = dense.shape[0] // 2
        return grads(self, state, dense[:h], ids[:h], labels[:h])

    monkeypatch.setattr(Engine, "_grads", first_half)


def loss_altered(monkeypatch):
    from recmodels_tpu_torch.train.engine import Engine

    step = Engine.train_step

    def altered(self, state, dense, ids, labels):
        state, m = step(self, state, dense, ids, labels)
        return state, {**m, "loss": m["loss"] * 1.05}

    monkeypatch.setattr(Engine, "train_step", altered)


@pytest.mark.parametrize("cell", TRAINING)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch, loss_altered])
def test_a_broken_training_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert small_run(cell)["correct"] is False


def answer_altered(monkeypatch):
    from recmodels_tpu_torch.serve import Predictor

    predict = Predictor.predict_logits

    def altered(self, dense, ids):
        z = predict(self, dense, ids).copy()
        z[0] += 1.0
        return z

    monkeypatch.setattr(Predictor, "predict_logits", altered)


def half_answered(monkeypatch):
    from recmodels_tpu_torch.serve import Predictor

    predict = Predictor.predict_logits

    def half(self, dense, ids):
        z = predict(self, dense, ids).copy()
        z[z.size // 2:] = 0.0
        return z

    monkeypatch.setattr(Predictor, "predict_logits", half)


@pytest.mark.parametrize("fault", [answer_altered, half_answered])
def test_a_broken_answer_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert small_run(SERVING)["correct"] is False


@pytest.mark.parametrize("cell", TRAINING + [SERVING])
def test_the_control_is_not_correct(cell):
    """The reference in fp8 put in the program's place, on three seeds."""
    root = root_of(cell)
    spec = json.loads(harness.cell_file(root, cell).read_text())
    params = {**spec["params"], **SMALL_PARAMS[spec["kind"]]}
    for seed in (1, 2, 3):
        h = harness.Run(cell, seed, 1, False, torch.device("cpu"), time.perf_counter(), root,
                        config_override=SMALL, cell_override={"params": params})
        try:
            fn = control.serving_readings if spec["kind"] == "serve_poisson" else control.training_readings
            numbers = next(x for name, x, *_ in fn(h, seed, "control") if name == "control_fp8")
        finally:
            h.close()
        assert not check.correct(check.judged(numbers, h.cell["limits"])), (seed, numbers)
