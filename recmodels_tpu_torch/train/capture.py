"""CUDA graphs of the training step, the eval step and the scorer: the port's
counterpart of ``jax.jit`` over ``Engine.train_step``, ``Engine.eval_step``
and ``Engine.logits``.

A step launches a hundred and more kernels, and the host's time to launch
them exceeds the card's time to run them; a graph replays them all at one
host call. What a replay needs from the code it replays:

* every tensor it reads or writes keeps its address: the state is updated in
  place (the step and Adam's count are device tensors, advanced in place;
  eval adds into the ``AUCState``'s tensors),
  the batch is copied into static input buffers before each replay, and the
  outputs are static tensors that the next replay overwrites, so callers get
  copies;
* every value that changes between steps is read from device memory: lr and
  the bias corrections (``embedding/update.py``); the kernels' routes, tensor
  maps and scratch are fixed by shapes and addresses, which do not change.

A graph is captured for one batch shape and one state (its tensors'
addresses): a new shape gets a graph of its own, as JAX retraces, and a call
with another state drops the graphs and captures again, so no replay writes
into the tensors of a state other than the one it was given. A capture that
fails raises; nothing falls back to eager steps on the card.

Tracing (``utils/profiling.py``): each call is a span (``train.step``, the
eval graphs' ``eval.step``) with children for the state key, the copy into
the static buffers and the replay, capture or warm-up; with no profiler
active a span is a flag check. A training step's graph has a timed twin,
captured right after it in the same memory pool, whose replays also record
CUDA timing events at the step's phases (``Engine._grads``, ``_apply``).
The twin replays only while a profiler is active, so an untraced run
replays exactly the plain graph. Every capture's host time adds to the
counter ``graph.capture_s``.
"""

from __future__ import annotations

from typing import Callable

import torch

from recmodels_tpu_torch.utils import profiling
from recmodels_tpu_torch.utils.profiling import annotate
from recmodels_tpu_torch.utils.tree import leaves


def warm_up(fn: Callable, stream: torch.cuda.Stream):
    """Run ``fn`` eagerly on ``stream``, ordered after the current stream's
    work and before its later work: what a capture on ``stream`` needs run
    once first (cuBLAS handles, the kernel library, cached constants)."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


def capture(fn: Callable, pool, stream: torch.cuda.Stream):
    """(graph, ``fn``'s static outputs): ``fn`` captured on ``stream`` into a
    CUDA graph whose memory comes from ``pool`` (None: a new pool). The
    capture executes nothing; ``graph.replay()`` runs it on the current
    stream."""
    graph = torch.cuda.CUDAGraph()
    with profiling.timed("graph.capture_s"), torch.cuda.graph(graph, pool=pool, stream=stream):
        out = fn()
    return graph, out


def state_key(state) -> tuple:
    """The address, shape and dtype of every tensor of ``state``: a graph
    captured on one state replays only into a state with the same key."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in leaves(state)
                 if isinstance(t, torch.Tensor))


class _Shape:
    """One batch shape's static input buffers and, on the card, its graph."""

    def __init__(self, batch, device: torch.device):
        self.inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=device) for t in batch)
        self.warm = False
        self.graph = None
        self.out = None  # the graph's static output
        self.twin = None  # the timed twin, its static output and its phase events
        self.twin_out = None
        self.marks = None


class _Captured:
    """Graphs of ``fn(state, *batch)``, one per batch shape, for one state.

    On a CUDA state, for each batch shape: the first call copies the batch
    into static buffers and runs ``fn`` eagerly on a side stream (a real step
    of the sequence); the second copies it in, captures ``fn`` (which
    executes nothing) and replays it once; later calls copy in and replay.
    On a CPU state every call copies into the same buffers and runs ``fn``
    on them. ``span`` names the calls' spans; ``timed``: capture each
    graph's timed twin as well."""

    span = "train.step"
    timed = False

    def __init__(self, fn: Callable):
        self.fn = fn
        self._spans = {k: f"{self.span}.{k}" for k in ("key", "copy_in", "warm_up", "capture", "replay")}
        self._state = None  # state_key of the state the graphs write into
        self._shapes: dict[tuple, _Shape] = {}
        self._pool = None  # one memory pool for every shape's graph
        self._stream = None

    @property
    def graphs(self) -> int:
        """How many graphs are captured (one per batch shape)."""
        return sum(s.graph is not None for s in self._shapes.values())

    def step(self, state, batch):
        """``fn`` of ``state`` on ``batch`` (a tuple of tensors); returns
        ``fn``'s output, on the card the graph's static output: copy it
        before the next call."""
        with annotate(self.span):
            return self._step(state, batch)

    def _step(self, state, batch):
        spans = self._spans
        with annotate(spans["key"]):
            key = state_key(state)
        if key != self._state:  # another state: its own buffers and graphs
            self._shapes.clear()
            self._pool = None
            self._state = key
        device = next(t for t in leaves(state) if isinstance(t, torch.Tensor)).device
        sig = tuple((tuple(t.shape), t.dtype) for t in batch)
        shape = self._shapes.get(sig)
        if shape is None:
            shape = self._shapes[sig] = _Shape(batch, device)
        with annotate(spans["copy_in"]):
            for buf, t in zip(shape.inputs, batch):
                buf.copy_(t)
        run = lambda: self.fn(state, *shape.inputs)  # noqa: E731
        if device.type != "cuda":
            return run()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if not shape.warm:
            with annotate(spans["warm_up"]):
                out = warm_up(run, self._stream)
                for t in leaves(out):
                    if isinstance(t, torch.Tensor):
                        t.record_stream(torch.cuda.current_stream(device))
            shape.warm = True
            return out
        if shape.graph is None:
            with annotate(spans["capture"]):
                shape.graph, shape.out = capture(run, self._pool, self._stream)
                self._pool = shape.graph.pool()
                if self.timed:
                    with profiling.timed_capture() as marks:
                        shape.twin, shape.twin_out = capture(run, self._pool, self._stream)
                    shape.marks = marks
                shape.graph.replay()
            return shape.out
        with annotate(spans["replay"]):
            if shape.twin is not None and profiling.tracing():
                profiling.replay_timed(shape.twin, shape.marks)
                return shape.twin_out
            shape.graph.replay()
        return shape.out


class CapturedStep(_Captured):
    """``Engine.jit_train_step``'s callable: ``(state, dense, ids, labels) ->
    (state, {'loss', 'overflow'})``, as ``Engine.train_step``; ``fn`` is the
    step returning its metrics. The tensors handed back are copies: the
    static outputs change at the next replay. Each shape's graph has a timed
    twin."""

    timed = True

    def __call__(self, state, dense: torch.Tensor, ids: torch.Tensor, labels: torch.Tensor):
        out = self.step(state, (dense, ids, labels))
        return state, {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


class CapturedEval(_Captured):
    """``Engine.jit_eval_step``'s callable: ``(state, auc_state, dense, ids,
    labels, weight=None) -> auc_state``, as ``Engine.eval_step``; ``fn``
    takes ``(state, auc_state)`` as its state, so a graph belongs to both,
    and a batch with ``weight`` has graphs of its own."""

    span = "eval.step"

    def __call__(self, state, auc_state, dense: torch.Tensor, ids: torch.Tensor, labels: torch.Tensor,
                 weight: torch.Tensor | None = None):
        batch = (dense, ids, labels) if weight is None else (dense, ids, labels, weight)
        self.step((state, auc_state), batch)
        return auc_state
