"""The outer training loop: data feed, logging, eval, checkpoint, resume
(port of ``recmodels_tpu/train/loop.py``).

``Trainer(cfg).run()`` trains ``cfg``'s model on its data for ``cfg.steps``
steps through the engine's CUDA graphs (``jit_train_step`` or
``jit_train_scan``, their accumulated forms when ``accum_steps > 1``),
evaluates on a held-out stream every ``eval_every`` steps (``jit_eval_step``),
logs every ``log_every`` and checkpoints every ``ckpt_every`` (the state
with both optimizers' and the data cursor), and resumes from the latest
checkpoint of ``cfg.ckpt_dir``. The host reads a device value only at a
log, an eval or a checkpoint. With ``data="device_synth"`` the batches are
generated on the device inside the captured step (``jit_train_scan_gen``):
no producer, no batch bytes from the host; ``val_data="device_synth"`` (or
that ``data`` alone) evaluates on the generated held-out stream the same
way.

Several devices (``n_devices``, default the process group's size): one
process a device in a group of exactly that many ranks
(``parallel.multihost``), the tables row-sharded over its mesh. Every rank
runs this same loop on its own shard of the data (``host_shard()``), a
batch of ``batch_size`` examples a rank (the global batch is ``batch_size``
times the ranks, the JAX package's semantics for a device a process), and
feeds it to the engine's per-rank steps; the primary alone writes
TensorBoard scalars, the run's config and the checkpoints.

Spans (``utils/profiling.annotate``, in the ``profile_dir`` trace):
``trainer.wait`` (the training thread waits for a superbatch),
``trainer.put`` (a batch array to the device), ``trainer.sync`` (the log's
device read), ``trainer.eval``, ``trainer.save``; in the producer thread
``producer.build`` (a superbatch made and stacked) and ``producer.wait``
(blocked on a full queue).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import queue
import threading
import time

import numpy as np
import torch

from recmodels_tpu_torch.data.criteo import Batch, CriteoTSVSource, SyntheticSource
from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.parallel import build_parallel_engine, make_mesh, multihost, shard_state
from recmodels_tpu_torch.train import metrics as metrics_lib
from recmodels_tpu_torch.train.checkpoint import CheckpointManager
from recmodels_tpu_torch.train.engine import Engine, resolve_device
from recmodels_tpu_torch.train.schedules import build_lr_schedule
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema
from recmodels_tpu_torch.utils.logging import MetricsLogger
from recmodels_tpu_torch.utils.profiling import annotate, trace

VAL_SEED_OFFSET = 7_777_777  # the held-out stream's seed: cfg.seed + this

__all__ = ["Trainer", "build_engine", "build_schema", "build_source", "make_producer_pool"]


def build_source(cfg: TrainConfig, schema: Schema, spec: str, seed: int,
                 shard_index: int = 0, shard_count: int = 1, loop: bool = True):
    """The source ``spec`` names: "synthetic", or the path of a Criteo TSV
    file (read with the native parser)."""
    if spec == "synthetic":
        return SyntheticSource(schema, cfg.batch_size, seed=seed, shard_index=shard_index,
                               shard_count=shard_count)
    return CriteoTSVSource(spec, schema, cfg.batch_size, shard_index=shard_index,
                           shard_count=shard_count, loop=loop, shuffle_buffer=cfg.shuffle_buffer,
                           seed=seed)


def make_producer_pool(source, workers: int, steps):
    """The batches of ``steps`` of a random-access source
    (``SyntheticSource``), generated in ``workers`` spawned processes
    (``data/genpool.BatchPool``; the caller closes it); None for other
    sources or one worker."""
    from recmodels_tpu_torch.data import genpool

    return genpool.make_pool(source, workers, steps)


def build_engine(cfg: TrainConfig, mesh=None) -> Engine:
    """``cfg``'s engine: its model, both optimizers with their schedules
    and decay, on local tables, or on tables row-sharded over ``mesh``
    (``parallel.build_parallel_engine`` with ``cfg.capacity_factor``)."""

    def schedule(base):
        s = build_lr_schedule(base, cfg.lr_schedule, warmup_steps=cfg.warmup_steps,
                              total_steps=cfg.steps, end_scale=cfg.lr_end_scale)
        return None if isinstance(s, float) else s

    model = build_model(cfg.model, build_schema(cfg), **cfg.model_kwargs())
    kw = dict(dense_optimizer=cfg.dense_optimizer, sparse_optimizer=cfg.sparse_optimizer, dense_lr=cfg.dense_lr,
              emb_lr=cfg.emb_lr, dense_lr_schedule=schedule(cfg.dense_lr), emb_lr_schedule=schedule(cfg.emb_lr),
              dense_weight_decay=cfg.dense_weight_decay)
    if mesh is None:
        return Engine(model, **kw)
    return build_parallel_engine(model, mesh, capacity_factor=cfg.capacity_factor, **kw)


class Trainer:
    """Trains ``cfg``'s model on ``device`` (default the CUDA card; raises
    without one). ``profile_dir``, when set before ``run``, records a
    ``torch.profiler`` trace of superbatches 2-4 there.

    ``n_devices`` > 1 (or, when it is None, a process group of several
    ranks) runs the sharded engine over the group's mesh, whose device
    (NCCL: this rank's card; gloo: the CPU) must be of ``device``'s type;
    without a group of exactly that many ranks it raises ``RuntimeError``
    saying how to start one."""

    def __init__(self, cfg: TrainConfig, logger: MetricsLogger | None = None, device="cuda"):
        if cfg.accum_steps > 1 and cfg.batch_size % cfg.accum_steps:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by accum_steps {cfg.accum_steps}")
        n_dev = cfg.n_devices or multihost.host_shard()[1]
        if n_dev > 1 and "device_synth" in (cfg.data, cfg.val_data):
            raise NotImplementedError("data=device_synth drives the single-device product loop; use the host "
                                      "pipeline for meshes")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_devices = n_dev
        self.schema = build_schema(cfg)
        self.mesh = None
        self._shard = lambda state: state
        if n_dev > 1:
            world = multihost.host_shard()[1]
            if world != n_dev:
                raise RuntimeError(
                    f"n_devices={n_dev} runs one process a device in a process group of {n_dev} ranks, and this "
                    f"process is in {'a group of ' + str(world) if world > 1 else 'none'}: launch it with "
                    f"`torchrun --nproc_per_node {n_dev} -m recmodels_tpu_torch.cli.train ...`, or call "
                    f"recmodels_tpu_torch.parallel.multihost.initialize(address, {n_dev}, rank) in each process")
            self.mesh = make_mesh(n_dev)
            if self.mesh.device.type != self.device.type:
                raise ValueError(f"the process group's collectives run on {self.mesh.device}, not {self.device}")
            self.device = self.mesh.device
            self._shard = lambda state: shard_state(state, self.mesh)
        self.logger = logger or MetricsLogger(cfg.tb_dir if multihost.is_primary() else None)
        # a mesh's engine steps take this rank's block of the batch: the
        # per-rank form of the parallel steps (parallel/train_step.py)
        self.engine = build_engine(cfg, self.mesh)
        self.eval_step = self.engine.jit_eval_step()
        if cfg.accum_steps > 1:
            self.train_step = self.engine.jit_train_step_accum()
            self.train_scan = self.engine.jit_train_scan_accum() if cfg.scan_steps > 1 else None
        else:
            self.train_step = self.engine.jit_train_step()
            self.train_scan = self.engine.jit_train_scan() if cfg.scan_steps > 1 else None
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, save_interval_steps=cfg.ckpt_every, mesh=self.mesh)
                     if cfg.ckpt_dir else None)
        self.profile_dir: str | None = None
        self.state = None
        self._auc_state = None
        self._eval_gen = None  # (the captured generated eval, its batch index)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """A host batch array on the device. On the card it goes through
        pinned memory, so the copy does not hold the host; this runs in the
        training thread only, between steps: a CUDA call from another thread
        while a step's graph is being captured would break the capture."""
        with annotate("trainer.put"):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t

    # ------------------------------------------------------------------ run
    def run(self) -> dict:
        """Train to ``cfg.steps`` (from the latest checkpoint, if any);
        returns the last eval's {'auc', 'logloss'} ({} without eval). The
        final state is ``self.state``.

        Superbatches of ``scan_steps`` steps (the ragged tail shorter). With
        ``data="device_synth"`` each is that many replays of
        ``jit_train_scan_gen``'s graph, batch n drawn on the device from the
        step counter n (no producer; one device and no accumulation, as the
        JAX loop). Otherwise a producer thread builds them as numpy and
        records the data cursor after each; a cursor is checkpointed only
        once its superbatch has been trained on, so a resumed run replays
        exactly the examples not yet consumed."""
        cfg = self.cfg
        generated = cfg.data == "device_synth"
        if generated and cfg.accum_steps > 1:
            raise NotImplementedError("device_synth does not compose with accum_steps")
        state = self._shard(self.engine.init(seed=cfg.seed, device=self.device))
        if generated:
            from recmodels_tpu_torch.data.device_synth import DeviceSynthSource, make_device_batch_fn

            source = DeviceSynthSource(self.schema, cfg.batch_size, seed=cfg.seed)
        else:
            shard_index, shard_count = multihost.host_shard()
            source = build_source(cfg, self.schema, cfg.data, seed=cfg.seed, shard_index=shard_index,
                                  shard_count=shard_count)
        start_step = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, data_state = self.ckpt.restore(state)
            source.set_state(data_state)
            start_step = int(state.step)
            self.logger.log_text(f"resumed from checkpoint at step {start_step}")
        if cfg.ckpt_dir and multihost.is_primary():
            os.makedirs(cfg.ckpt_dir, exist_ok=True)
            with open(os.path.join(cfg.ckpt_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())

        k = max(1, cfg.scan_steps)
        total = cfg.steps - start_step
        plan = [k] * (total // k) + ([total % k] if total % k else [])
        if generated:
            scan = self.engine.jit_train_scan_gen(make_device_batch_fn(self.schema, cfg.batch_size, seed=cfg.seed))
            ends = itertools.accumulate(plan, initial=start_step)
            next(ends)
            # replay kk reads its batch index from state.step
            return self._train(state, start_step, source.state(),
                               ((kk, {"step": end}, functools.partial(scan, k=kk)) for kk, end in zip(plan, ends)))

        workers = cfg.producer_workers
        if workers == 0:  # auto: parallel generation for synthetic data only
            workers = min(8, (os.cpu_count() or 4) // 2) if cfg.data == "synthetic" else 1
        s0 = source.state()["step"] if isinstance(source, SyntheticSource) else 0
        pool = make_producer_pool(source, workers, range(s0, s0 + total))
        if pool is not None:
            # random-access batches from the workers; the source's cursor
            # advances here, so state() and resume are unchanged
            def next_batch():
                d, i, l = next(pool)
                source._step += 1
                return Batch(dense=d, ids=i, labels=l)
        else:
            it = iter(source)

            def next_batch():
                return next(it)

        q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch_batches))
        stop = threading.Event()
        err: list[BaseException] = []

        a = cfg.accum_steps

        def producer():
            try:
                for kk in plan:
                    with annotate("producer.build"):
                        parts = [next_batch() for _ in range(kk)]
                        lead = 0 if (kk == 1 and k == 1) else 1  # a scan axis in front?
                        arrays = tuple(getattr(parts[0], f) if lead == 0
                                       else np.stack([getattr(b, f) for b in parts])
                                       for f in ("dense", "ids", "labels"))
                        if a > 1:
                            # each batch as A micro-batches: [.., B, ...] -> [.., A, B/A, ...]
                            arrays = tuple(x.reshape(x.shape[:lead] + (a, x.shape[lead] // a) + x.shape[lead + 1:])
                                           for x in arrays)
                        item = (kk, lead, arrays, source.state())
                    with annotate("producer.wait"):
                        while not stop.is_set():
                            try:
                                q.put(item, timeout=0.2)
                                break
                            except queue.Full:
                                continue
                    if stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — raised in the training thread
                if not stop.is_set():  # else the run is over and nobody reads q
                    err.append(e)
                    q.put(None)

        def superbatches():
            for _ in plan:
                with annotate("trainer.wait"):
                    item = q.get()
                if item is None:
                    raise err[0]
                kk, lead, arrays, cursor = item
                step = self.train_step if lead == 0 else self.train_scan
                # the batch goes to the device when the superbatch trains
                yield kk, cursor, lambda state: step(state, *(self._put(x) for x in arrays))

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            return self._train(state, start_step, source.state(), superbatches())
        finally:
            stop.set()
            if pool is not None:
                pool.close()

    def _train(self, state, start_step: int, cursor: dict, superbatches) -> dict:
        """The loop both feeds share: for each (steps, data cursor after
        them, ``train(state) -> (state, metrics)``) of ``superbatches``,
        train, then log every ``log_every`` (the host's one device sync of
        the interval), evaluate every ``eval_every`` and checkpoint with the
        cursor; a ``torch.profiler`` trace of superbatches 2-4 when
        ``profile_dir`` is set. Then the last eval and checkpoint."""
        cfg = self.cfg
        t_last = time.time()
        examples_since = 0
        final: dict = {}
        step_no = start_step
        with contextlib.ExitStack() as profiling:
            for n_sb, (kk, cursor, train) in enumerate(superbatches):
                if self.profile_dir is not None and n_sb == 2:
                    profiling.enter_context(trace(self.profile_dir))
                state, m = train(state)
                prev = step_no
                step_no += kk
                examples_since += kk * cfg.batch_size
                if self.profile_dir is not None and n_sb == 4:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    profiling.close()
                    self.logger.log_text(f"profiler trace written to {self.profile_dir}")
                if prev // cfg.log_every != step_no // cfg.log_every:
                    with annotate("trainer.sync"):
                        loss = float(m["loss"])  # the device sync of the interval
                    now = time.time()
                    self.logger.log_scalars(step_no, {
                        "loss": loss,
                        "examples_per_sec": examples_since / max(now - t_last, 1e-9),
                        # dropped lookups of every rank (local tables drop none)
                        "embedding_overflow": float(m.get("overflow", 0)),
                    })
                    t_last, examples_since = now, 0
                if cfg.eval_every and prev // cfg.eval_every != step_no // cfg.eval_every:
                    final = self.evaluate(state, step_no)
                if self.ckpt is not None:
                    with annotate("trainer.save"):
                        self.ckpt.save(step_no, state, data_state=cursor)
        if cfg.eval_every and cfg.steps % cfg.eval_every:
            final = self.evaluate(state, cfg.steps)
        if self.ckpt is not None:
            if self.ckpt.latest_step() != cfg.steps:  # the loop may have saved it
                with annotate("trainer.save"):
                    self.ckpt.save(cfg.steps, state, data_state=cursor, force=True)
            self.ckpt.wait()
        self.state = state
        return final

    def _zeroed_auc_state(self):
        """The Trainer's one AUC state, zeroed: one state for every eval, so
        the eval graphs are kept."""
        if self._auc_state is None:
            self._auc_state = metrics_lib.auc_init(device=self.device)
        for t in self._auc_state:
            t.zero_()
        return self._auc_state

    def _log_eval(self, step_no: int) -> dict:
        out = metrics_lib.auc_compute(self._auc_state)
        scalars = {"auc": float(out["auc"]), "logloss": float(out["logloss"])}
        self.logger.log_scalars(step_no, scalars, prefix="val")
        return scalars

    def evaluate(self, state, step_no: int) -> dict:
        """AUC and logloss over ``eval_batches`` batches of the held-out
        stream (synthetic data: the seed ``cfg.seed + 7,777,777``, the same
        planted task; ``device_synth``: that stream generated on the
        device); logged under ``val``. The span ``trainer.eval``."""
        with annotate("trainer.eval"):
            return self._evaluate(state, step_no)

    def _evaluate(self, state, step_no: int) -> dict:
        cfg = self.cfg
        if (cfg.val_data or cfg.data) == "device_synth":
            return self._evaluate_device_synth(state, step_no)
        # each rank evaluates its own shard; the engine sums the histograms
        shard_index, shard_count = multihost.host_shard()
        val_src = build_source(cfg, self.schema, cfg.val_data or cfg.data, seed=cfg.seed + VAL_SEED_OFFSET,
                               shard_index=shard_index, shard_count=shard_count)
        auc_state = self._zeroed_auc_state()
        vit = iter(val_src)
        for _ in range(cfg.eval_batches):
            b = next(vit)
            self.eval_step(state, auc_state, *(self._put(x) for x in (b.dense, b.ids, b.labels)))
        return self._log_eval(step_no)

    def _evaluate_device_synth(self, state, step_no: int) -> dict:
        """The held-out generated stream (the seed ``cfg.seed +
        VAL_SEED_OFFSET``, the same planted task): batches 0 ..
        ``eval_batches`` - 1 at every eval, each generated and scored by one
        replay of ``jit_eval_gen``'s graph from a device batch index."""
        from recmodels_tpu_torch.data.device_synth import make_device_batch_fn

        cfg = self.cfg
        if self._eval_gen is None:
            val_fn = make_device_batch_fn(self.schema, cfg.batch_size, seed=cfg.seed + VAL_SEED_OFFSET)
            self._eval_gen = (self.engine.jit_eval_gen(val_fn),
                              torch.zeros((), dtype=torch.int32, device=self.device))
        eval_gen, index = self._eval_gen
        auc_state = self._zeroed_auc_state()
        index.zero_()
        for _ in range(cfg.eval_batches):
            eval_gen(state, auc_state, index)
        return self._log_eval(step_no)
