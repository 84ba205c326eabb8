"""The batch-generation pool of the training loop (port of
``recmodels_tpu/data/genpool.py``).

Numpy generation holds the interpreter lock, so the loop generates batches of
a random-access source (``SyntheticSource._make(step)``) in spawned worker
processes. A worker imports only this module and the numpy-side data
modules it unpickles, never torch: the parent may hold the CUDA device, and
forking a process that has started CUDA is unsafe, so the workers are
spawned, see no device (``CUDA_VISIBLE_DEVICES=""``) and do not import the
parent's main module (a script's top-level ``import torch``).

The workers run under a ``ProcessPoolExecutor`` with a bounded number of
batches in flight. Its shutdown lets a running batch finish and reads it
before the workers exit. (``multiprocessing.Pool.terminate`` puts a
sentinel on the result pipe under the lock that a worker holds while it
writes a batch of megabytes, which nothing may read any more.)
"""

from __future__ import annotations

import collections
import contextlib
import os
import pickle
import sys

_POOL_SRC = None  # a worker's source, set once by pool_init in that worker


def pool_init(src_bytes: bytes) -> None:
    global _POOL_SRC
    _POOL_SRC = pickle.loads(src_bytes)


def pool_make(step: int):
    b = _POOL_SRC._make(step)
    return b.dense, b.ids, b.labels


@contextlib.contextmanager
def spawn_env():
    """While workers are spawned: no CUDA device in their environment, and
    the parent's ``__main__`` hidden from them (multiprocessing would
    import it in each child; the workers need nothing from it)."""
    main = sys.modules.get("__main__")
    hidden = {k: main.__dict__[k] for k in ("__spec__", "__file__") if main is not None and k in main.__dict__}
    saved_cuda = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    for k in hidden:
        if k == "__spec__":
            main.__spec__ = None
        else:
            del main.__dict__[k]
    try:
        yield
    finally:
        if main is not None:
            main.__dict__.update(hidden)
        if saved_cuda is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved_cuda


class BatchPool:
    """The batches (dense, ids, labels) of ``steps`` in order, made by
    ``workers`` spawned processes, at most ``2 * workers`` ahead of the
    reader. ``executor`` is the ``ProcessPoolExecutor`` of the workers;
    ``close`` cancels what has not started and waits for the rest."""

    def __init__(self, source, workers: int, steps):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        self.executor = ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"), initializer=pool_init,
                                            initargs=(pickle.dumps(source),))
        self._steps = iter(steps)
        self._ahead: collections.deque = collections.deque()
        with spawn_env():  # each submit spawns a worker until there are `workers`
            for _ in range(2 * workers):
                self._submit()

    def _submit(self) -> None:
        step = next(self._steps, None)
        if step is not None:
            self._ahead.append(self.executor.submit(pool_make, step))

    def __iter__(self):
        return self

    def __next__(self):
        if not self._ahead:
            raise StopIteration
        batch = self._ahead.popleft().result()
        self._submit()
        return batch

    def close(self) -> None:
        self.executor.shutdown(wait=True, cancel_futures=True)


def make_pool(source, workers: int, steps):
    """A ``BatchPool`` making the batches of ``steps`` of a random-access
    source; None when the source has no random access or ``workers`` <= 1.
    The caller closes it."""
    from recmodels_tpu_torch.data.criteo import SyntheticSource

    if not isinstance(source, SyntheticSource) or workers <= 1:
        return None
    return BatchPool(source, workers, steps)
