"""Checkpoint and resume: port of ``recmodels_tpu/train/checkpoint.py``
(orbax there, ``torch.save`` here), without ``restore_cross_geometry``:
the port has one table layout until the sharded path exists.

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


class CheckpointManager:
    """Numbered checkpoints of a training run in ``directory``.

    ``save`` writes when forced, and otherwise at a step past the latest
    checkpoint that is a multiple of ``save_interval_steps`` or is the
    first (orbax's default policy); it keeps the newest ``max_to_keep``
    checkpoints (None: all)."""

    def __init__(self, directory: str, max_to_keep: int | None = 3, save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):  # left by a run killed while writing
            if PARTIAL in name:
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        self._lock = threading.Lock()  # guards _steps, which the writer prunes
        self._steps = self._complete_steps()  # on disk, or being written
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None

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
        raises ``ValueError``."""
        if not force and not self.should_save(step):
            return False
        if step in self.all_steps():
            raise ValueError(f"checkpoint {step} already exists in {self.directory}")
        self.wait()
        host = _to_host(state._asdict())
        data = json.dumps(data_state or {})
        with self._lock:
            self._steps = sorted(self._steps + [step])
        self._writer = threading.Thread(target=self._write, args=(step, host, data), daemon=False)
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

    def restore(self, target_state: TrainState, step: int | None = None):
        """Copy checkpoint ``step`` (default: the latest) into the tensors of
        ``target_state``; returns (target_state, data_state). Raises
        ``FileNotFoundError`` when there is no such checkpoint and
        ``ValueError`` when its tensors do not fit the state's."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        path = os.path.join(self.directory, str(step))
        if not os.path.isfile(os.path.join(path, STATE_FILE)):
            raise FileNotFoundError(f"no checkpoint {step} in {self.directory}")
        saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
        with open(os.path.join(path, DATA_FILE)) as f:
            data = json.load(f)
        _copy_into(target_state._asdict(), saved, "state")
        return target_state, data

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
