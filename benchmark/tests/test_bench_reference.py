"""The plain reference against the program's plain PyTorch path on the CPU,
in f32 at a small size: the same logits, the same three training steps
(BCE, autograd grads, Adam, Adagrad), the same token hash. The reference
itself imports nothing of the program; these tests do."""

import numpy as np
import pytest
import torch

from benchmark import check, port, training
from benchmark.gen import weights as W
from benchmark.gen import zipf
from benchmark.reference import criteo
from benchmark.reference import model as ref_model
from benchmark.reference.precision import rounding

PARAMS = {"zipf_exponent": 1.05, "dense_log_mean": 1.0, "dense_log_std": 1.5, "dense_max": 9999999,
          "dense_missing": 0.1, "label_rate": 0.25}


def config(model):
    cfg = {"model": model, "n_dense": 13, "n_slots": 26, "vocab_size": 300, "embed_dim": 16,
           "hidden": [32, 32] if model == "xdeepfm" else [32, 32, 32], "compute_dtype": "float32",
           "batch_size": 256, "dense_lr": 1e-3, "emb_lr": 1e-2, "initial_accumulator": 0.1, "init_scale": 0.05}
    if model == "xdeepfm":
        cfg["cin_sizes"] = [16, 16]
    return cfg


def batches(cfg, seed, k):
    slots = zipf.ZipfSlots([cfg["vocab_size"]] * 26, cfg["vocab_size"], 1.05, seed, "cpu")
    return zipf.batch_pool(slots, k, cfg["batch_size"], 13, PARAMS, zipf.generator(seed, "cpu", 5))


@pytest.mark.parametrize("model", ["xdeepfm", "deepfm"])
def test_logits_match_the_programs_plain_path(model):
    cfg, seed = config(model), 5
    engine = port.build_engine(cfg)
    state = port.serve_state(engine, cfg, seed, "cpu")
    dense, ids, _ = (t[0] for t in batches(cfg, seed, 1))
    with torch.no_grad():
        got = engine.logits(state, dense, ids)
    gids = ids.long() + torch.arange(26) * cfg["vocab_size"]
    rows = W.initial_rows(cfg, seed, gids.reshape(-1)).reshape(*ids.shape, -1)
    want = ref_model.logits(cfg, W.dense_weights(cfg, seed, "cpu"), rows, dense, rounding("f32"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["xdeepfm", "deepfm"])
def test_three_training_steps_match(model):
    cfg, seed = config(model), 6
    engine = port.build_engine(cfg)
    state = port.train_state(engine, cfg, seed, "cpu")
    dense, ids, labels = batches(cfg, seed, 3)
    probe = port.StepProbe(state, cfg, seed)
    losses, _ = training.first_steps(engine.jit_train_scan(), state, dense, ids, labels, probe)
    ref = port.program_layout(cfg, training.reference_readings(cfg, seed, dense, ids, labels))
    numbers = check.train_numbers(probe.readings(losses), ref)
    assert numbers["loss_gap"] < 1e-5, numbers
    assert numbers["grad_gap"] < 1e-4, numbers
    # the table's gradient is read back from Adagrad's move, (w0 - w1) / lr: a small move is a few
    # ulps of its weight, so that reading carries a relative error near 1e-4 even in f32
    assert numbers["grad_err"] < 1e-3, numbers
    assert numbers["change_gap"] < 1e-4, numbers
    assert set(probe.grad) == set(ref["grad"]) and len(ref["grad"]) >= 8


def test_token_hash_matches_the_programs():
    from recmodels_tpu_torch.data import hashing

    tokens = [b"68fd1e64", b"0000000a", b"FFFFFFFF", b"", b"not-hex!", b"0123456789abcdef0", b"z" * 3,
              b"05db9164", b"1", b"abcdefABCDEF1234"]
    vocab = 1_000_000
    toks = np.array([[t] * 26 for t in tokens], dtype=object)
    want = hashing.hash_tokens(toks, [vocab] * 26)
    got = np.array([[criteo.bucket(t, s, vocab) for s in range(26)] for t in tokens])
    np.testing.assert_array_equal(got, want)


def test_the_control_rounds_and_the_reference_does_not():
    x = torch.randn(1000, dtype=torch.float32) * 3
    assert torch.equal(rounding("f32")(x), x)
    y = rounding("fp8")(x)
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert 0.005 < float(rel.mean()) < 0.07 and float(rel.max()) <= 0.0625 + 1e-6
    with pytest.raises(ValueError):
        rounding("int3")
