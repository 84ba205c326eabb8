"""The Wukong cell (``wukong-criteo1tb.train-zipf``, traffic kind
``train_pool_wukong``) on the CPU at a small size: its slots' rows cut to at
most 3,000, the batch to 128 and the stack to 2 layers (every width kept),
f32 compute. The door writes the reference's weights into the program; the
reference's three steps pass the check against themselves, and a sound run
is correct; the program broken underneath (its state left unchanged, half of
each batch, which on the card the table's rows alone tell,
``table_rows_missed``, each loss altered by 5%) and the fp8 control are not.
The counts, ``table_rows_missed`` and the new readers by hand."""

import json
import time

import pytest
import torch

from benchmark import check, counts_wukong, harness, port_multihot, port_wukong
from benchmark.gen import multihot
from benchmark.port import dense_leaves, table_of
from benchmark.traffic import train_pool_wukong as kind
from test_bench_multihot import half_batch, loss_altered, unchanged_state

from conftest import ROOT

CELL = "wukong-criteo1tb.train-zipf"
CONFIG = json.loads((ROOT / "benchmark/configs/wukong-criteo1tb.json").read_text())
ROWS = [min(r, 3000) for r in CONFIG["num_embeddings_per_feature"]]
SMALL = {"num_embeddings_per_feature": ROWS, "batch_size": 128, "n_layers": 2, "compute_dtype": "float32"}
LIMITS = json.loads(harness.cell_file(ROOT, CELL).read_text())["limits"]


def small_run(seed: int = 7, trace: bool = False) -> dict:
    torch.set_num_threads(4)
    params = {**json.loads(harness.cell_file(ROOT, CELL).read_text())["params"], "pool_batches": 10,
              "warm_superbatches": 1, "trace_superbatches": 1}
    run = harness.Run(CELL, seed, 0.2, trace, torch.device("cpu"), time.perf_counter(), ROOT,
                      config_override=SMALL, cell_override={"params": params})
    return harness.run_cell(run)


def _batches(cfg: dict, seed: int, n: int = 3):
    params = json.loads(harness.cell_file(ROOT, CELL).read_text())["params"]
    slots = multihot.slots_for(cfg, params, seed, "cpu")
    return multihot.batch_pool(slots, n, cfg["batch_size"], 13, params, multihot.zipf.generator(seed, "cpu", 5))


def test_the_door_writes_the_references_weights():
    cfg = {**CONFIG, **SMALL}
    engine = port_wukong.build_engine(cfg)
    state = port_wukong.train_state(engine, cfg, 11, "cpu")
    ref = port_wukong.dense_weights(cfg, 11, "cpu")
    prog = dense_leaves(state)
    assert set(prog) == set(ref) and "layers.0.proj" in prog and "layers.1.proj" not in prog
    assert all(torch.equal(prog[k], ref[k]) for k in ref)
    table = table_of(state)
    first = multihot.table_block(cfg, 11, 3, 0, "cpu")
    off = multihot.slot_offsets(cfg)[3]
    assert torch.equal(table[off:off + first.shape[0]], first)


def test_the_references_steps_pass_the_check_against_themselves():
    cfg = {**CONFIG, **SMALL}
    ref = kind.reference_readings(cfg, 7, *_batches(cfg, 7))
    assert check.correct(check.judged(kind.numbers(ref, ref), LIMITS))


def test_a_sound_run_is_correct_and_reads_the_programs_counters():
    res = small_run(trace=True)
    assert res["correct"] is True and res["attempted"] >= 10 and res["failed"] == 0
    # a CPU run has no device trace and no peak: the readers of device time
    # and of the peak report nothing
    assert not {"wukong_fm_roofline", "wukong_ln_roofline", "wukong_train_mfu_pct"} & set(res["metrics"])
    assert "host_ms_per_step.train" in res["metrics"]


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, loss_altered])
def test_a_broken_program_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert small_run()["correct"] is False


def test_half_a_batch_fails_the_table_rows_alone(monkeypatch):
    # the rows only the left-out examples touch stay where they were
    half_batch(monkeypatch)
    rows = small_run()["checks"]["table_rows_missed"]
    assert rows["value"] > rows["limit"]


def _rows(ids, rows):
    return torch.tensor(ids), port_multihot.with_wide(torch.tensor(rows, dtype=torch.float32))


@pytest.mark.parametrize("prog, want", [
    (([3, 5, 9], [[1.0, 0.0], [0.0, 2.0], [3.0, 4.0]]), 0.0),  # the same rows in another order
    (([3, 5, 9], [[2.0, 0.0], [0.0, 4.0], [6.0, 8.0]]), 0.0),  # each row's gradient doubled
    (([3, 9], [[1.0, 0.0], [3.0, 4.0]]), 1 / 3),  # one row left
    (([3, 5, 9, 7], [[1.0, 0.0], [0.0, 2.0], [3.0, 4.0], [1.0, 1.0]]), 1 / 3),  # one row too many
    (([3, 5, 9, 7], [[1.0, 0.0], [0.0, 2.0], [3.0, 4.0], [0.0, 0.0]]), 0.0),  # a row the program holds unmoved
    (([], []), 1.0),  # nothing moved
])
def test_the_table_rows_missed_by_hand(prog, want):
    # the reference's row 4 has a zero gradient: no row to move
    ref = _rows([9, 3, 5, 4], [[3.0, 4.0], [1.0, 0.0], [0.0, 2.0], [0.0, 0.0]])
    ids, rows = prog
    got = _rows(ids, rows) if ids else (torch.zeros(0, dtype=torch.long), torch.zeros((0, 3)))
    assert kind.table_rows_missed(got, ref) == pytest.approx(want)


def test_the_fp8_control_fails_a_limit():
    cfg = {**CONFIG, **SMALL}
    batches = _batches(cfg, 7)
    ref = kind.reference_readings(cfg, 7, *batches)
    low = kind.reference_readings(cfg, 7, *batches, precision="fp8")
    assert not check.correct(check.judged(kind.numbers(low, ref), LIMITS))


def test_step_operations_and_fm_bytes_by_hand():
    d, k = 128, 32
    fm = 2 * 2 * d * k * (27 + 7 * 32)
    lcb = 2 * 16 * d * (27 + 7 * 32)
    mlp_f = 2 * (27 * k * 2048 + 2048 * 2048) + 7 * 2 * (32 * k * 2048 + 2048 * 2048)
    top = 2 * (4096 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256)
    fwd = (214 - 26) * d + 2 * (13 * 512 + 512 * 256 + 256 * 128) + fm + lcb + mlp_f + 2 * 27 * 32 * d + top
    assert sum(counts_wukong.forward_flops(CONFIG).values()) == fwd
    assert 352e6 < counts_wukong.step_flops(CONFIG, 1) < 353e6
    per_layer = lambda n: (n * d + n * k + 16 * d) * 2 + 8 + (3 * n * d + n * k + 16 * d) * 2 + 8  # noqa: E731
    assert counts_wukong.fm_bytes(CONFIG, 10) == 10 * (per_layer(27) + 7 * per_layer(32))
    ln_layer = 4 * 32 * d * 2 + 32 * 8 + (3 * 32 * d + 16 * d) * 2 + 32 * 8
    assert counts_wukong.ln_bytes(CONFIG, 10) == 10 * 8 * ln_layer


def test_the_new_readers_stand_down_without_their_inputs(monkeypatch):
    from benchmark import program_trace
    from benchmark.profile import Trace

    load = lambda name: harness.load_module(harness.metric_file(ROOT, name), f"t_{name}")  # noqa: E731
    trace = Trace(device_ops=[("void (anonymous namespace)::wukong_fm_fwd_kernel<32, 1>(bf16 const*)", 0, 1_000_000),
                              ("void (anonymous namespace)::wukong_fm_bwd_kernel<32, 1>(bf16 const*)", 0, 2_000_000),
                              ("void (anonymous namespace)::wukong_fm_grad_sum_kernel<32, 1>(float const*)", 0,
                               100_000),
                              ("void (anonymous namespace)::wukong_ln_fwd_kernel<128>(bf16 const*)", 0, 1_500_000),
                  ("void (anonymous namespace)::wukong_ln_bwd_kernel<128>(bf16 const*)", 0, 1_400_000),
                  ("void (anonymous namespace)::wukong_ln_grad_sum_kernel(float const*)", 0, 100_000),
                  ("void (anonymous namespace)::bag_gather_kernel<__nv_bfloat16, 4>(float)", 0, 1_000_000)],
                  window_s=1.0, steps=1)
    ctx = {"kind": "train", "trace": trace, "config": CONFIG, "card": "NVIDIA H100 80GB HBM3", "batch_size": 16384,
           "examples_per_s": 1.0e6}
    readers = ("wukong_fm_roofline", "wukong_ln_roofline")
    monkeypatch.setattr(program_trace, "snapshot", lambda: None)  # a program without the counter
    assert all(load(r).read(ctx) is None for r in readers)
    monkeypatch.setattr(program_trace, "snapshot", lambda: {"counters": {"wukong.fm_layers": 0}, "phases": {}})
    assert all(load(r).read(ctx) is None for r in readers)
    monkeypatch.setattr(program_trace, "snapshot", lambda: {"counters": {"wukong.fm_layers": 24}, "phases": {}})
    share = load("wukong_fm_roofline").read(ctx)
    assert share == pytest.approx(100.0 * counts_wukong.fm_bytes(CONFIG, 16384) / 3.35e12 * 1e3 / 3.1)
    share = load("wukong_ln_roofline").read(ctx)
    assert share == pytest.approx(100.0 * counts_wukong.ln_bytes(CONFIG, 16384) / 3.35e12 * 1e3 / 3.0)
    assert all(load(r).read({**ctx, "config": {**CONFIG, "model": "dlrm_dcnv2"}}) is None for r in readers)
    no_ln = Trace(device_ops=[op for op in trace.device_ops if "wukong_ln" not in op[0]], window_s=1.0, steps=1)
    assert load("wukong_ln_roofline").read({**ctx, "trace": no_ln}) is None
    assert load("wukong_train_mfu_pct").read(ctx) == pytest.approx(
        100.0 * counts_wukong.step_flops(CONFIG, 1) * 1.0e6 / 989e12)
    assert load("wukong_train_mfu_pct").read({**ctx, "config": {"model": "dlrm_dcnv2"}}) is None
