"""The port's tracing (``recmodels_tpu_torch/utils/profiling.py``): spans
that cost a flag check with no profiler, their nesting in the training step
and the Trainer, the set-up counters, and the timed twin of a captured
step's graph.

The card tests (marker ``cuda``) skip without a GPU; the file imports no
JAX, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import io
import json

import pytest
import torch

from recmodels_tpu_torch.data import SyntheticSource
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.train.loop import Trainer
from recmodels_tpu_torch.utils import profiling
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema
from recmodels_tpu_torch.utils.logging import MetricsLogger
from recmodels_tpu_torch.utils.tree import leaves

PHASES = ["step.gather", "step.forward", "step.backward", "step.dense_opt", "step.sparse_update"]


def _engine(model="xdeepfm", batch=256, n=3, seed=3, device="cpu", **kw):
    """A small engine and ``n`` batches of its schema on ``device``."""
    cfg = TrainConfig(model=model, vocab_size=1000, embed_dim=8, hidden=(32, 32), **kw)
    schema = build_schema(cfg)
    eng = Engine(build_model(model, schema, **cfg.model_kwargs()))
    it = iter(SyntheticSource(schema, batch_size=batch, seed=seed))
    batches = [tuple(torch.as_tensor(a, device=device) for a in (b.dense, b.ids, b.labels))
               for b in (next(it) for _ in range(n))]
    return eng, batches


def _stacked(batches):
    return tuple(torch.stack([b[i] for b in batches]) for i in range(3))


def _spans(prof):
    """The profiler's host events named by the port's spans: (name, start ns,
    end ns), in start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA") and e.name().startswith(("train.", "step.")):
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler, ``annotate`` and ``phase`` hand back the one shared
    no-op context, and an eager step, a scan of the static-buffer step and a
    Trainer superbatch create no ``record_function``."""

    def refuse(*a, **kw):
        raise AssertionError("a record_function was created with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.tracing()
    assert profiling.annotate("train.step") is profiling._NULL
    assert profiling.phase("step.gather") is profiling._NULL
    eng, batches = _engine()
    state = eng.init(seed=0, device="cpu")
    eng.train_step(state, *batches[0])
    eng.jit_train_scan()(state, *_stacked(batches))
    t = Trainer(TrainConfig(model="fm", vocab_size=500, embed_dim=8, batch_size=64, steps=4, scan_steps=2,
                            log_every=2, eval_every=4, eval_batches=1, n_devices=1, producer_workers=1),
                logger=MetricsLogger(stream=io.StringIO()), device="cpu")
    t.run()
    assert int(state.step) == 4 and int(t.state.step) == 4


def test_step_spans_nest_under_a_profiler():
    """Under ``torch.profiler`` on the CPU: an eager ``train_step`` gives the
    five phases in order; a ``jit_train_scan`` call gives ``train.scan`` ⊃
    one ``train.step`` a batch ⊃ ``train.step.key``, ``train.step.copy_in``
    and the five phases, in that order."""
    eng, batches = _engine()
    state = eng.init(seed=0, device="cpu")
    scan = eng.jit_train_scan()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.train_step(state, *batches[0])
    spans = _spans(prof)
    assert [s[0] for s in spans] == PHASES
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))  # one after another

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        scan(state, *_stacked(batches))
    spans = _spans(prof)
    scans = [s for s in spans if s[0] == "train.scan"]
    steps = [s for s in spans if s[0] == "train.step"]
    assert len(scans) == 1 and len(steps) == len(batches)
    assert all(_inside(s, scans[0]) for s in spans)
    for step in steps:
        children = [s[0] for s in spans if s is not step and _inside(s, step)]
        assert children == ["train.step.key", "train.step.copy_in"] + PHASES


def test_trainer_trace_holds_the_trainer_spans(tmp_path):
    """A CPU ``Trainer.run`` with ``profile_dir`` (superbatches 2-4 traced)
    writes a trace holding the wait for a superbatch, the copy to the
    device, the log's sync, the eval and the checkpoint's save, besides the
    step's, and the producer thread's spans (it builds superbatches 5-7
    while 2-4 train)."""
    cfg = TrainConfig(model="fm", vocab_size=500, embed_dim=8, batch_size=64, steps=20, scan_steps=2,
                      log_every=2, eval_every=4, eval_batches=1, n_devices=1, producer_workers=1,
                      ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2)
    t = Trainer(cfg, logger=MetricsLogger(stream=io.StringIO()), device="cpu")
    t.profile_dir = str(tmp_path / "trace")
    t.run()
    names = {e.get("name") for e in json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]}
    want = {"trainer.wait", "trainer.put", "trainer.sync", "trainer.save", "trainer.eval", "train.scan",
            "train.step", "eval.step", "producer.build"}
    assert want <= names, want - names


def test_snapshot_on_the_cpu_has_no_device_counters():
    """The CPU path captures no graph and loads no kernel library: the
    set-up counters are absent or zero, and no timed replay left a
    phase sample."""
    eng, batches = _engine()
    state = eng.init(seed=0, device="cpu")
    eng.jit_train_scan()(state, *_stacked(batches))
    snap = profiling.snapshot()
    assert snap["counters"].get("graph.capture_s", 0) == 0
    assert snap["counters"].get("kernels.load_s", 0) == 0
    assert snap["phases"] == {}


class _Event:
    """A stand-in for a CUDA timing event: ``t`` ms, done or not."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_timed_replays_are_read_only_when_done(monkeypatch):
    """``replay_timed`` reads the previous timed replay's events before
    replaying, only if the device has passed the last of them (a replay
    still running is dropped, never waited for); a phase marked twice in a
    step is summed; ``snapshot`` waits for the last replay; counters add."""
    monkeypatch.setattr(profiling, "_samples", {})
    monkeypatch.setattr(profiling, "_pending", None)
    monkeypatch.setattr(profiling, "_counters", {})
    graph = _Graph()
    ev = [_Event(t) for t in (0.0, 1.5, 1.5, 4.0, 4.0, 4.25)]
    marks = [("step.gather", ev[0], ev[1]), ("step.forward", ev[2], ev[3]), ("step.gather", ev[4], ev[5])]
    profiling.replay_timed(graph, marks)
    ev[5].done = False
    profiling.replay_timed(graph, marks)  # the first replay is still running: dropped
    assert profiling._samples == {}
    ev[5].done = True
    profiling.replay_timed(graph, marks)  # the second has finished: read
    assert profiling._samples == {"step.gather": [1.75], "step.forward": [2.5]}
    ev[5].done = False
    snap = profiling.snapshot()  # waits for the third
    assert snap["phases"] == {"step.gather": [1.75, 1.75], "step.forward": [2.5, 2.5]}
    assert graph.replays == 3 and profiling._pending is None
    profiling.count("graph.capture_s", 0.25)
    profiling.count("graph.capture_s", 0.5)
    assert profiling.snapshot()["counters"] == {"graph.capture_s": 0.75}


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and timing events have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tensors(state):
    return [t for t in leaves(state) if isinstance(t, torch.Tensor)]


def _count_twin_replays(monkeypatch) -> list:
    calls = []
    replay_timed = profiling.replay_timed

    def counted(graph, marks):
        calls.append(graph)
        replay_timed(graph, marks)

    monkeypatch.setattr(profiling, "replay_timed", counted)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("path", [dict(model="xdeepfm", cin_sizes=(32, 32), bf16=True),
                                  dict(model="deepfm", bf16=True)], ids=["xdeepfm", "deepfm"])
def test_timed_twin_replays_leave_the_plain_graphs_bits(cuda, path, monkeypatch):
    """Six ``jit_train_scan`` steps (the warm-up, the capture and its replay,
    three replays) traced, so the replays after the capture run the timed
    twin, against the same steps untraced: losses and every state tensor
    bit for bit; the untraced run replays the twin zero times."""
    eng, batches = _engine(batch=512, n=6, device=cuda, **path)
    traced, plain = eng.init(seed=0, device=cuda), eng.init(seed=0, device=cuda)
    calls = _count_twin_replays(monkeypatch)
    scan_plain, scan_traced = eng.jit_train_scan(), eng.jit_train_scan()
    _, mp = scan_plain(plain, *_stacked(batches))
    torch.cuda.synchronize()
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        _, mt = scan_traced(traced, *_stacked(batches))
        torch.cuda.synchronize()
    assert len(calls) == 4  # replays after the capture call
    assert torch.equal(mp["losses"], mt["losses"])
    assert all(torch.equal(a, b) for a, b in zip(_tensors(traced), _tensors(plain)))


@pytest.mark.cuda
def test_phase_samples_are_positive_and_sum_to_the_twins_span(cuda, monkeypatch):
    """Traced replays of the twin, each read (a sync after each): every
    phase sample is positive, each replay gives one sample a phase, and the
    last replay's phases sum to within 2% of its first-to-last event span;
    the captures added to ``graph.capture_s`` (the plain graph and its
    twin)."""
    monkeypatch.setattr(profiling, "_samples", {})
    monkeypatch.setattr(profiling, "_pending", None)
    eng, batches = _engine(batch=8192, n=6, device=cuda, cin_sizes=(32, 32), bf16=True)
    state = eng.init(seed=0, device=cuda)
    ts = eng.jit_train_step()
    before = profiling.snapshot()["counters"].get("graph.capture_s", 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        for b in batches:
            ts(state, *b)
            torch.cuda.synchronize()
    snap = profiling.snapshot()
    assert snap["counters"]["graph.capture_s"] > before
    assert sorted(snap["phases"]) == sorted(PHASES)
    assert all(len(v) == 4 and min(v) > 0 for v in snap["phases"].values()), snap["phases"]
    (shape,) = ts._shapes.values()
    span = shape.marks[0][1].elapsed_time(shape.marks[-1][2])
    total = sum(v[-1] for v in snap["phases"].values())
    assert abs(total - span) <= 0.02 * span, (total, span)


@pytest.mark.cuda
def test_kernel_library_load_is_counted(cuda):
    """The first ``build.library()`` added its time to ``kernels.load_s``
    and 0 or 1 to ``kernels.built``."""
    from recmodels_tpu_torch.ops.cuda import build

    build.library()
    counters = profiling.snapshot()["counters"]
    assert counters["kernels.load_s"] > 0 and counters["kernels.built"] in (0, 1)
