"""The multi-hot cell (``dlrm-dcnv2-criteo1tb.train-zipf``, traffic kind
``train_pool_multihot``) on the CPU at a small size: its slots' rows cut to
at most 3,000 and the batch to 256 (every width kept), f32 compute. A sound
run is correct; the program broken underneath (its state left unchanged,
half of each batch) and the fp8 control are not. Each loss altered by 5% is
read (``loss_gap``, on stderr) but not judged: the cell names no loss limit.
The generator, the counts and the readers by hand."""

import json
import time

import pytest
import torch

from benchmark import check, counts_dcnv2, harness
from benchmark.gen import multihot
from benchmark.traffic import train_pool_multihot as kind

from conftest import ROOT

CELL = "dlrm-dcnv2-criteo1tb.train-zipf"
CONFIG = json.loads((ROOT / "benchmark/configs/dlrm-dcnv2-criteo1tb.json").read_text())
ROWS = [min(r, 3000) for r in CONFIG["num_embeddings_per_feature"]]
SMALL = {"num_embeddings_per_feature": ROWS, "batch_size": 256, "compute_dtype": "float32"}


def small_run(seed: int = 7, trace: bool = False) -> dict:
    torch.set_num_threads(4)
    params = {**json.loads(harness.cell_file(ROOT, CELL).read_text())["params"], "pool_batches": 10,
              "warm_superbatches": 1, "trace_superbatches": 1}
    run = harness.Run(CELL, seed, 0.2, trace, torch.device("cpu"), time.perf_counter(), ROOT,
                      config_override=SMALL, cell_override={"params": params})
    return harness.run_cell(run)


def test_a_sound_run_is_correct_and_reads_the_programs_counters():
    res = small_run(trace=True)
    assert res["correct"] is True and res["attempted"] >= 10 and res["failed"] == 0
    # a CPU run has no device trace: the readers of device time report nothing
    assert "bag_gather_roofline" not in res["metrics"] and "host_ms_per_step.train" in res["metrics"]


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


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_a_broken_program_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert small_run()["correct"] is False


def test_an_altered_loss_is_read_but_not_judged(monkeypatch, capsys):
    # bf16's and fp8's loss gaps overlap at their tails on the card, so the
    # cell's limits leave the loss out; the run still prints its gap
    loss_altered(monkeypatch)
    res = small_run()
    assert "loss_gap" not in res["checks"] and res["correct"] is True
    numbers = capsys.readouterr().err.split("numbers ", 1)[1]
    assert float(numbers.split("'loss_gap': ", 1)[1].split(",", 1)[0]) == pytest.approx(0.05, rel=1e-3)


def test_the_fp8_control_fails_a_limit():
    cfg = {**CONFIG, **SMALL}
    h = harness.Run(CELL, 7, 0.2, False, torch.device("cpu"), time.perf_counter(), ROOT, config_override=SMALL)
    try:
        slots = multihot.slots_for(cfg, h.params, 7, "cpu")
        dense, ids, labels = multihot.batch_pool(slots, 3, 256, 13, h.params, multihot.zipf.generator(7, "cpu", 5))
        ref = kind.reference_readings(cfg, 7, dense, ids, labels)
        low = kind.reference_readings(cfg, 7, dense, ids, labels, precision="fp8")
        assert not check.correct(check.judged(check.train_numbers(low, ref), h.cell["limits"]))
        assert check.correct(check.judged(check.train_numbers(ref, ref), h.cell["limits"]))
    finally:
        h.close()


def test_the_generator_repeats_and_hashes_a_bag_from_its_first_id():
    cfg, params = {**CONFIG, **SMALL}, json.loads(harness.cell_file(ROOT, CELL).read_text())["params"]
    pools = [multihot.batch_pool(multihot.slots_for(cfg, params, 3, "cpu"), 2, 256, 13, params,
                                 multihot.zipf.generator(3, "cpu", 5)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*pools))
    ids = pools[0][1].reshape(-1, sum(cfg["hotness"]))
    assert ids.shape[1] == 214
    col = 0
    for s, (rows, h) in enumerate(zip(ROWS, cfg["hotness"])):
        bag = ids[:, col:col + h]
        assert int(bag.min()) >= 0 and int(bag.max()) < rows
        first = bag[:, 0]
        same = (first[:, None] == first[None, :]).nonzero()
        for a, b in same[:50].tolist():  # one first id, one bag
            assert torch.equal(bag[a], bag[b])
        col += h


def test_step_operations_by_hand():
    d, x0 = 128, 27 * 128
    fwd = (214 - 26) * d + 2 * (13 * 512 + 512 * 256 + 256 * 128) + 3 * (2 * 2 * x0 * 512 + 3 * x0) \
        + 2 * (x0 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256)
    assert sum(counts_dcnv2.forward_flops(CONFIG).values()) == fwd
    assert 96.0e6 < counts_dcnv2.step_flops(CONFIG, 1) < 96.5e6
    assert counts_dcnv2.bag_gather_bytes(10, 20, 3, 128) == 10 * 512 + 80 + 3 * 256


def test_the_new_readers_stand_down_without_their_inputs(monkeypatch):
    from benchmark import program_trace
    from benchmark.profile import Trace

    load = lambda name: harness.load_module(harness.metric_file(ROOT, name), f"t_{name}")  # noqa: E731
    trace = Trace(device_ops=[("void (anonymous namespace)::bag_gather_kernel<__nv_bfloat16, 4>(float const*)", 0,
                               2_000_000), ("void sorted_update::sorted_update_kernel<X>(Y)", 0, 4_000_000)],
                  window_s=1.0, steps=2)
    ctx = {"kind": "train", "trace": trace, "config": CONFIG, "card": "NVIDIA H100 80GB HBM3",
           "unique_rows_per_step": 2.0e6, "ids_per_step": 16384 * 214, "bags_per_step": 16384 * 26,
           "examples_per_s": 2.0e6}
    monkeypatch.setattr(program_trace, "snapshot", lambda: None)  # a program without the counters
    assert load("bag_gather_roofline").read(ctx) is None
    monkeypatch.setattr(program_trace, "snapshot", lambda: {
        "counters": {"emb.bag_lookups": 3 * 16384 * 214, "emb.bag_calls": 3}, "phases": {}})
    share = load("bag_gather_roofline").read(ctx)
    nbytes = 2.0e6 * 512 + 16384 * 214 * 4 + 16384 * 26 * 256
    assert share == pytest.approx(100.0 * nbytes / 3.35e12 * 1e3 / 1.0)
    assert 0 < load("bag_update_roofline").read(ctx) < 100
    assert load("dcnv2_train_mfu_pct").read(ctx) == pytest.approx(
        100.0 * counts_dcnv2.step_flops(CONFIG, 1) * 2.0e6 / 989e12)
    assert load("dcnv2_train_mfu_pct").read({**ctx, "config": {"model": "deepfm"}}) is None
