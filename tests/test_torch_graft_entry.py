"""The port's graft entry (``graft_entry_torch.py``) on the CPU: the
compile-check forward is the flagship's ``Engine.logits``, and the dry run
trains one sharded step in a gloo world of two processes."""

import pytest
import torch

import graft_entry_torch
from recmodels_tpu_torch.data import criteo_schema
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.train.engine import Engine


def test_entry_forward_is_the_flagship_logits():
    """bf16 xDeepFM at vocab 10,000, dim 16, CIN(128,128), DNN(400,400),
    seed 0, a batch of 256: ``forward`` gives ``Engine.logits`` of a model
    built apart, bit for bit, finite."""
    forward, (state, dense, ids) = graft_entry_torch.entry(device="cpu")
    assert dense.shape == (256, 13) and ids.shape == (256, 26)
    model = build_model("xdeepfm", criteo_schema(vocab_size=10_000, embed_dim=16), cin_sizes=(128, 128),
                        hidden=(400, 400), compute_dtype=torch.bfloat16)
    engine = Engine(model)
    with torch.no_grad():
        got = forward(state, dense, ids)
        want = engine.logits(engine.init(seed=0, device="cpu"), dense, ids)
    assert got.shape == (256,) and torch.isfinite(got).all() and torch.equal(got, want)


def test_dryrun_multichip_two_ranks_on_gloo(capsys):
    graft_entry_torch.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("dryrun_multichip(2): ok, loss=") and "nan" not in out


def test_dryrun_multichip_needs_the_cards(monkeypatch):
    """On "cuda" it raises without a card, and with fewer cards than ranks."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft_entry_torch.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"dryrun_multichip\(2\) needs 2 cards; this host has 1"):
        graft_entry_torch.dryrun_multichip(2)
