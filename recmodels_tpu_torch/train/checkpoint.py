"""Checkpoint and resume: port of ``recmodels_tpu/train/checkpoint.py``
(orbax there, ``torch.save`` here), for local and row-sharded states.

A checkpoint is a directory ``<dir>/<step>/`` holding ``state.pt`` (the
``TrainState`` as a dict of host tensors: the step, the dense parameters,
both optimizer states and the tables) and ``data.json`` (the data cursor).
It is written under a temporary name and renamed when complete, so a run
killed while writing leaves its last complete checkpoint, and a directory
that is not a step number holding ``state.pt`` is not a checkpoint.

The engine updates its state in place, so ``save`` copies the state to host
memory before it returns; a background thread writes that copy, and
``wait`` joins it (and raises what it raised). ``restore`` copies a
checkpoint into the tensors of the state it is given, its int32 step and
Adam's count included, and returns that state: a CUDA graph captured on the
state stays valid.

Sharded runs (a manager given the run's ``mesh``): every rank calls
``save`` with its own block of the state, and the row-sharded tensors are
gathered to the primary (``parallel.gather_state``, a collective, in the
calling thread), so the file holds the GLOBAL padded state: one
``state.pt`` whatever the world size that wrote it. Only the primary
creates, renames or deletes anything in the directory; the other ranks
keep the same list of steps, so ``should_save`` and ``latest_step`` decide
alike on every rank, and they take the primary's list (a broadcast, after
its writes are complete) when the manager starts and before any restore.
``restore`` copies each rank's rows of the file into its state. Where the
ranks' data cursors differ (Criteo TSV shards), ``data.json`` records each
rank's, and each rank resumes its own; equal cursors (the synthetic
stream's ``{"step": n}``) are stored once.

``restore_cross_geometry`` restores into another table geometry: local <->
sharded, or another world size (``ShardedTables.padded_rows`` depends on
it).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import torch

from recmodels_tpu_torch.train.engine import TrainState

STATE_FILE = "state.pt"
DATA_FILE = "data.json"
PARTIAL = ".partial"
PER_RANK = "per_rank_cursors"  # data.json's key when the ranks' cursors differ
ROW_FIELDS = ("emb_params", "emb_opt")  # split by rows over a mesh; the rest replicated


def _to_host(tree):
    """A copy of ``tree`` (dicts, lists and tensors) with every tensor in
    host memory."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _copy_into(target, saved, where: str) -> None:
    """Copy ``saved`` into the tensors of ``target``; raises ``ValueError``
    where their structures, shapes or dtypes differ."""
    if isinstance(target, dict):
        if not isinstance(saved, dict) or sorted(saved) != sorted(target):
            raise ValueError(f"checkpoint structure mismatch at {where}: "
                             f"{sorted(saved) if isinstance(saved, dict) else type(saved).__name__}, "
                             f"expected {sorted(target)}")
        for k in target:
            _copy_into(target[k], saved[k], f"{where}/{k}")
    elif isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise ValueError(f"checkpoint structure mismatch at {where}")
        for i, (t, s) in enumerate(zip(target, saved)):
            _copy_into(t, s, f"{where}/{i}")
    elif isinstance(target, torch.Tensor):
        if (not isinstance(saved, torch.Tensor) or saved.shape != target.shape
                or saved.dtype != target.dtype):
            got = (f"{saved.dtype} {tuple(saved.shape)}" if isinstance(saved, torch.Tensor)
                   else type(saved).__name__)
            raise ValueError(f"checkpoint structure mismatch at {where}: {got}, "
                             f"expected {target.dtype} {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(saved)
    elif saved is not None or target is not None:
        raise ValueError(f"checkpoint structure mismatch at {where}")


def _fit_rows(target, saved, where: str, rank: int, size: int) -> None:
    """Copy rows of ``saved`` (a table or sparse state, as a checkpoint of
    any geometry holds it) into ``target``, this rank's block of the
    target geometry: the saved rows padded with zero rows, or cut, to the
    target's global rows (``size`` blocks), then rows ``[rank*R,
    (rank+1)*R)``. Raises ``ValueError`` where the structures, the shapes
    past the row axis or the dtypes differ."""
    if isinstance(target, dict):
        if not isinstance(saved, dict) or sorted(saved) != sorted(target):
            raise ValueError(f"checkpoint structure mismatch at {where}: "
                             f"{sorted(saved) if isinstance(saved, dict) else type(saved).__name__}, "
                             f"expected {sorted(target)}")
        for k in target:
            _fit_rows(target[k], saved[k], f"{where}/{k}", rank, size)
    elif isinstance(target, torch.Tensor):
        if (not isinstance(saved, torch.Tensor) or saved.shape[1:] != target.shape[1:]
                or saved.dtype != target.dtype or target.dim() == 0):
            got = (f"{saved.dtype} {tuple(saved.shape)}" if isinstance(saved, torch.Tensor)
                   else type(saved).__name__)
            raise ValueError(f"checkpoint structure mismatch at {where}: {got}, "
                             f"expected rows of {target.dtype} {tuple(target.shape)}")
        rows = target.shape[0]
        lo = rank * rows
        n = max(0, min(rows, saved.shape[0] - lo))
        with torch.no_grad():
            target[:n].copy_(saved[lo:lo + n])
            target[n:].zero_()
    elif saved is not None or target is not None:
        raise ValueError(f"checkpoint structure mismatch at {where}")


def _own_rows(saved: dict, mesh) -> dict:
    """``saved`` (a global state's dict) with each row-sharded tensor cut to
    this rank's block of ``mesh``: the same geometry, another owner."""

    def cut(tree, where):
        if isinstance(tree, dict):
            return {k: cut(v, f"{where}/{k}") for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            return tree
        if tree.dim() == 0 or tree.shape[0] % mesh.size:
            raise ValueError(f"checkpoint structure mismatch at {where}: {tuple(tree.shape)} does not split over "
                             f"{mesh.size} ranks (another geometry: restore_cross_geometry)")
        per = tree.shape[0] // mesh.size
        return tree[mesh.rank * per:(mesh.rank + 1) * per]

    return {f: cut(v, f) if f in ROW_FIELDS else v for f, v in saved.items()}


class CheckpointManager:
    """Numbered checkpoints of a training run in ``directory``.

    ``save`` writes when forced, and otherwise at a step past the latest
    checkpoint that is a multiple of ``save_interval_steps`` or is the
    first (orbax's default policy); it keeps the newest ``max_to_keep``
    checkpoints (None: all). ``mesh``: the mesh of a sharded run, whose
    every rank makes its own manager (then ``save``, ``restore`` and the
    manager's start are collectives, run by every rank in its training
    thread)."""

    def __init__(self, directory: str, max_to_keep: int | None = 3, save_interval_steps: int = 1, mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.mesh = mesh
        self.primary = mesh is None or mesh.rank == 0
        self._lock = threading.Lock()  # guards _steps, which the writer prunes
        self._steps: list[int] = []  # on disk, or being written
        if self.primary:
            os.makedirs(self.directory, exist_ok=True)
            for name in os.listdir(self.directory):  # left by a run killed while writing
                if PARTIAL in name:
                    shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
            self._steps = self._complete_steps()
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        self._sync()

    def _sync(self) -> None:
        """Every rank takes the primary's list of steps (after ``wait``
        there: its writes are complete)."""
        if self.mesh is None or self.mesh.size == 1:
            return
        import torch.distributed as dist

        box = [self.all_steps() if self.primary else None]
        src = dist.get_global_rank(self.mesh.group, 0) if self.mesh.group is not None else 0
        dist.broadcast_object_list(box, src=src, group=self.mesh.group, device=self.mesh.device)
        with self._lock:
            self._steps = list(box[0])

    def _complete_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, STATE_FILE)))

    def all_steps(self) -> list[int]:
        with self._lock:
            return list(self._steps)

    def latest_step(self) -> int | None:
        """The newest checkpoint's step (one still being written included),
        or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return latest is None or step % self.save_interval_steps == 0

    def save(self, step: int, state: TrainState, data_state: dict | None = None,
             force: bool = False) -> bool:
        """Copy ``state`` to host memory and write it with ``data_state``
        (JSON) as checkpoint ``step`` in the background; returns whether it
        saves. ``force`` saves whatever the interval; a step that exists
        raises ``ValueError``. With a mesh every rank calls it with its own
        block and cursor, and the primary writes."""
        if not force and not self.should_save(step):
            return False
        if step in self.all_steps():
            raise ValueError(f"checkpoint {step} already exists in {self.directory}")
        self.wait()
        data = data_state or {}
        if self.mesh is not None:
            from recmodels_tpu_torch.parallel.train_step import gather_state

            if self.mesh.size > 1:
                import torch.distributed as dist

                cursors = [None] * self.mesh.size
                dist.all_gather_object(cursors, data, group=self.mesh.group)
                data = cursors[0] if all(c == cursors[0] for c in cursors) else {PER_RANK: cursors}
            state = gather_state(state, self.mesh)  # None but on the primary
        with self._lock:
            self._steps = sorted(self._steps + [step])
            if not self.primary and self.max_to_keep is not None:
                self._steps = self._steps[-self.max_to_keep:]
        if not self.primary:
            return True
        host = _to_host(state._asdict())
        self._writer = threading.Thread(target=self._write, args=(step, host, json.dumps(data)), daemon=False)
        self._writer.start()
        return True

    def _write(self, step: int, host: dict, data: str) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = final + PARTIAL
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(host, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, DATA_FILE), "w") as f:
                f.write(data)
            os.rename(tmp, final)
            if self.max_to_keep is not None:
                for old in self._complete_steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)))
                    with self._lock:
                        self._steps = [s for s in self._steps if s != old]
        except BaseException as e:  # raised by wait() in the caller's thread
            shutil.rmtree(tmp, ignore_errors=True)
            with self._lock:
                self._steps = [s for s in self._steps if s != step]
            self._error = e

    def _load(self, step: int | None):
        """(checkpoint ``step``'s state dict, its data.json, the step), the
        latest by default, once every rank knows the same steps."""
        self.wait()
        self._sync()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        path = os.path.join(self.directory, str(step))
        if not os.path.isfile(os.path.join(path, STATE_FILE)):
            raise FileNotFoundError(f"no checkpoint {step} in {self.directory}")
        saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
        with open(os.path.join(path, DATA_FILE)) as f:
            data = json.load(f)
        return saved, data, step

    @staticmethod
    def _cursor(data: dict, mesh, step: int) -> dict:
        """This rank's data cursor of a checkpoint's data.json. Per-rank
        cursors resume only in a world of as many ranks: raises
        ``ValueError`` in any other rather than guess."""
        if not (isinstance(data, dict) and PER_RANK in data):
            return data
        cursors, world = data[PER_RANK], 1 if mesh is None else mesh.size
        if len(cursors) != world:
            raise ValueError(f"checkpoint {step} holds one data cursor for each of {len(cursors)} ranks; a world "
                             f"of {world} cannot resume them")
        return cursors[0 if mesh is None else mesh.rank]

    def restore(self, target_state: TrainState, step: int | None = None):
        """Copy checkpoint ``step`` (default: the latest) into the tensors of
        ``target_state`` (with a mesh: this rank's rows); returns
        (target_state, data_state). Raises ``FileNotFoundError`` when there
        is no such checkpoint and ``ValueError`` when its tensors do not fit
        the state's (another table geometry: ``restore_cross_geometry``)."""
        saved, data, step = self._load(step)
        if self.mesh is not None:
            saved = _own_rows(saved, self.mesh)
        _copy_into(target_state._asdict(), saved, "state")
        return target_state, self._cursor(data, self.mesh, step)

    def restore_cross_geometry(self, target_state: TrainState, step: int | None = None, mesh=None):
        """Restore checkpoint ``step`` (default: the latest) into another
        table geometry: local <-> sharded, or one world size <-> another.
        ``target_state`` is a live state of the TARGET engine (local, or
        this rank's block over ``mesh``, default the manager's). Every
        table and its sparse optimizer rows go saved -> rows padded with
        zero rows, or cut, to the target's global rows (``padded_rows`` of
        the target's world; ``alloc_rows`` when local) -> this rank's
        block, as the JAX package's ``_fit_geometry`` does; the padding rows
        hold zeros, which no step reads. The dense parameters, the dense
        optimizer's state and the step pass through unchanged. The port has
        no packed 3-D table layout, so JAX's packed branch has no
        counterpart here. Copies into ``target_state``'s tensors; returns
        (target_state, data_state). Raises ``ValueError`` where the
        structures differ, and for per-rank data cursors of another world
        size."""
        mesh = mesh if mesh is not None else self.mesh
        saved, data, step = self._load(step)
        self._fit(target_state, saved, mesh)
        return target_state, self._cursor(data, mesh, step)

    @staticmethod
    def _fit(target_state: TrainState, saved: dict, mesh) -> None:
        target = target_state._asdict()
        if not isinstance(saved, dict) or sorted(saved) != sorted(target):
            raise ValueError(f"checkpoint structure mismatch at state: "
                             f"{sorted(saved) if isinstance(saved, dict) else type(saved).__name__}, "
                             f"expected {sorted(target)}")
        rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
        for f in TrainState._fields:
            if f in ROW_FIELDS:
                _fit_rows(target[f], saved[f], f"state/{f}", rank, size)
            else:
                _copy_into(target[f], saved[f], f"state/{f}")

    def wait(self) -> None:
        """Join the background write; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
