"""The outer training loop: data feed, logging, eval, checkpoint, resume
(port of ``recmodels_tpu/train/loop.py`` for one device).

``Trainer(cfg).run()`` trains ``cfg``'s model on its data for ``cfg.steps``
steps through the engine's CUDA graphs (``jit_train_step`` or
``jit_train_scan``, their accumulated forms when ``accum_steps > 1``),
evaluates on a held-out stream every ``eval_every`` steps (``jit_eval_step``),
logs every ``log_every`` and checkpoints every ``ckpt_every`` (the state
with both optimizers' and the data cursor), and resumes from the latest
checkpoint of ``cfg.ckpt_dir``. The host reads a device value only at a
log, an eval or a checkpoint. In-graph data generation
(``data="device_synth"``) and more than one device are not ported yet.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time

import numpy as np
import torch

from recmodels_tpu_torch.data.criteo import Batch, CriteoTSVSource, SyntheticSource
from recmodels_tpu_torch.data.schema import Schema
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.train import metrics as metrics_lib
from recmodels_tpu_torch.train.checkpoint import CheckpointManager
from recmodels_tpu_torch.train.engine import Engine, resolve_device
from recmodels_tpu_torch.train.schedules import build_lr_schedule
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema
from recmodels_tpu_torch.utils.logging import MetricsLogger
from recmodels_tpu_torch.utils.profiling import trace

VAL_SEED_OFFSET = 7_777_777  # the held-out stream's seed: cfg.seed + this

__all__ = ["Trainer", "build_schema", "build_source", "make_producer_pool"]


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


class Trainer:
    """Trains ``cfg``'s model on ``device`` (default the CUDA card; raises
    without one). ``profile_dir``, when set before ``run``, records a
    ``torch.profiler`` trace of superbatches 2-4 there."""

    def __init__(self, cfg: TrainConfig, logger: MetricsLogger | None = None, device="cuda"):
        if cfg.data == "device_synth" or cfg.val_data == "device_synth":
            raise NotImplementedError(
                "data='device_synth' (in-graph batch generation, Engine.train_scan_gen) is not "
                "ported yet: ROADMAP.md queue 1, item 6")
        if (cfg.n_devices or 1) > 1:
            raise NotImplementedError(
                f"n_devices={cfg.n_devices}: the sharded path (parallel/) is not ported yet: "
                "ROADMAP.md queue 1, item 7")
        if cfg.accum_steps > 1 and cfg.batch_size % cfg.accum_steps:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by accum_steps {cfg.accum_steps}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_devices = 1
        self.schema = build_schema(cfg)
        self.logger = logger or MetricsLogger(cfg.tb_dir)

        def schedule(base):
            s = build_lr_schedule(base, cfg.lr_schedule, warmup_steps=cfg.warmup_steps,
                                  total_steps=cfg.steps, end_scale=cfg.lr_end_scale)
            return None if isinstance(s, float) else s

        self.engine = Engine(
            build_model(cfg.model, self.schema, **cfg.model_kwargs()),
            dense_optimizer=cfg.dense_optimizer, sparse_optimizer=cfg.sparse_optimizer,
            dense_lr=cfg.dense_lr, emb_lr=cfg.emb_lr, dense_lr_schedule=schedule(cfg.dense_lr),
            emb_lr_schedule=schedule(cfg.emb_lr), dense_weight_decay=cfg.dense_weight_decay,
        )
        self.eval_step = self.engine.jit_eval_step()
        if cfg.accum_steps > 1:
            self.train_step = self.engine.jit_train_step_accum()
            self.train_scan = self.engine.jit_train_scan_accum() if cfg.scan_steps > 1 else None
        else:
            self.train_step = self.engine.jit_train_step()
            self.train_scan = self.engine.jit_train_scan() if cfg.scan_steps > 1 else None
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, save_interval_steps=cfg.ckpt_every)
                     if cfg.ckpt_dir else None)
        self.profile_dir: str | None = None
        self.state = None
        self._auc_state = None

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """A host batch array on the device. On the card it goes through
        pinned memory, so the copy does not hold the host; this runs in the
        training thread only, between steps: a CUDA call from another thread
        while a step's graph is being captured would break the capture."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------ run
    def run(self) -> dict:
        """Train to ``cfg.steps`` (from the latest checkpoint, if any);
        returns the last eval's {'auc', 'logloss'} ({} without eval). The
        final state is ``self.state``."""
        cfg = self.cfg
        state = self.engine.init(seed=cfg.seed, device=self.device)
        source = build_source(cfg, self.schema, cfg.data, seed=cfg.seed)
        start_step = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, data_state = self.ckpt.restore(state)
            source.set_state(data_state)
            start_step = int(state.step)
            self.logger.log_text(f"resumed from checkpoint at step {start_step}")
        if cfg.ckpt_dir:
            os.makedirs(cfg.ckpt_dir, exist_ok=True)
            with open(os.path.join(cfg.ckpt_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())

        # The producer thread builds superbatches of k batches (the ragged
        # tail shorter) and records the data cursor after each; a cursor is
        # checkpointed only once its superbatch has been trained on, so a
        # resumed run replays exactly the examples not yet consumed.
        k = max(1, cfg.scan_steps)
        total = cfg.steps - start_step
        plan = [k] * (total // k) + ([total % k] if total % k else [])
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
                    parts = [next_batch() for _ in range(kk)]
                    lead = 0 if (kk == 1 and k == 1) else 1  # a scan axis in front?
                    arrays = tuple(getattr(parts[0], f) if lead == 0 else np.stack([getattr(b, f) for b in parts])
                                   for f in ("dense", "ids", "labels"))
                    if a > 1:
                        # each batch as A micro-batches: [.., B, ...] -> [.., A, B/A, ...]
                        arrays = tuple(x.reshape(x.shape[:lead] + (a, x.shape[lead] // a) + x.shape[lead + 1:])
                                       for x in arrays)
                    item = (kk, lead, arrays, source.state())
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

        th = threading.Thread(target=producer, daemon=True)
        th.start()

        t_last = time.time()
        examples_since = 0
        final: dict = {}
        step_no = start_step
        last_cursor = source.state()
        profiling = contextlib.ExitStack()
        try:
            for n_sb, _ in enumerate(plan):
                item = q.get()
                if item is None:
                    raise err[0]
                kk, lead, arrays, cursor = item
                last_cursor = cursor
                if self.profile_dir is not None and n_sb == 2:
                    profiling.enter_context(trace(self.profile_dir))
                dense, ids, labels = (self._put(x) for x in arrays)
                if lead == 0:
                    state, m = self.train_step(state, dense, ids, labels)
                else:
                    state, m = self.train_scan(state, dense, ids, labels)
                prev = step_no
                step_no += kk
                examples_since += kk * cfg.batch_size
                if self.profile_dir is not None and n_sb == 4:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    profiling.close()
                    self.logger.log_text(f"profiler trace written to {self.profile_dir}")
                if prev // cfg.log_every != step_no // cfg.log_every:
                    loss = float(m["loss"])  # the device sync of the interval
                    now = time.time()
                    self.logger.log_scalars(step_no, {
                        "loss": loss,
                        "examples_per_sec": examples_since / max(now - t_last, 1e-9),
                        # local tables drop no lookups: always 0 here
                        "embedding_overflow": float(m.get("overflow", 0)),
                    })
                    t_last, examples_since = now, 0
                if cfg.eval_every and prev // cfg.eval_every != step_no // cfg.eval_every:
                    final = self.evaluate(state, step_no)
                if self.ckpt is not None:
                    self.ckpt.save(step_no, state, data_state=cursor)
        finally:
            stop.set()
            profiling.close()
            if pool is not None:
                pool.close()
        if cfg.eval_every and cfg.steps % cfg.eval_every:
            final = self.evaluate(state, cfg.steps)
        if self.ckpt is not None:
            if self.ckpt.latest_step() != cfg.steps:  # the loop may have saved it
                self.ckpt.save(cfg.steps, state, data_state=last_cursor, force=True)
            self.ckpt.wait()
        self.state = state
        return final

    def evaluate(self, state, step_no: int) -> dict:
        """AUC and logloss over ``eval_batches`` batches of the held-out
        stream (synthetic data: the seed ``cfg.seed + 7,777,777``, the same
        planted task); logged under ``val``."""
        cfg = self.cfg
        val_src = build_source(cfg, self.schema, cfg.val_data or cfg.data,
                               seed=cfg.seed + VAL_SEED_OFFSET)
        # one AUC state, zeroed for each eval, so the eval graphs are kept
        if self._auc_state is None:
            self._auc_state = metrics_lib.auc_init(device=self.device)
        for t in self._auc_state:
            t.zero_()
        vit = iter(val_src)
        for _ in range(cfg.eval_batches):
            b = next(vit)
            self.eval_step(state, self._auc_state,
                           *(self._put(x) for x in (b.dense, b.ids, b.labels)))
        out = metrics_lib.auc_compute(self._auc_state)
        scalars = {"auc": float(out["auc"]), "logloss": float(out["logloss"])}
        self.logger.log_scalars(step_no, scalars, prefix="val")
        return scalars
