"""One rank of a gloo world for ``tests/test_torch_multihost.py`` and
``tests/test_torch_cross_geometry.py``; imports no JAX.

    python tests/torch_multihost_worker.py MODE RANK WORLD PORT OUT_DIR [ARG ...]

The rank joins the world with ``multihost.initialize("127.0.0.1:PORT",
WORLD, RANK, device="cpu")``, runs MODE and writes what it produced to
``OUT_DIR/rank<RANK>.pkl`` (numpy arrays and plain values):

  steps START        three per-rank sharded steps of FM (vocab 400, dim 8,
                     capacity 4.0) from the global state START (a
                     ``torch.save``d state dict), each rank on its own
                     shard of the synthetic stream (32 examples a rank);
  trainer START CKPT TB
                     the Trainer's product path (6 steps, scan 2, eval
                     every 3, checkpoints every 3) from START, then its
                     restore drill, then a manager's save and restore of
                     cursors that differ by rank (at CKPT/cursors);
  kill CKPT KILL_AT  the Trainer for 8 steps, checkpoints every 2, from the
                     port's own init; rank 1 SIGKILLs itself when it calls
                     its step the (KILL_AT + 1)-th time (KILL_AT 0: never);
  geometry SRC DST BATCH
                     ``restore_cross_geometry`` of checkpoint SRC into this
                     world's sharded FM (vocab 700), its logits on this
                     rank's block of BATCH, and a save to DST.

The tests start a world with ``start`` and read it with ``finish``.
"""

import hashlib
import os
import pickle
import signal
import socket
import subprocess
import sys
import time
import traceback
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recmodels_tpu_torch.data import SyntheticSource, criteo_schema  # noqa: E402
from recmodels_tpu_torch.models import build_model  # noqa: E402
from recmodels_tpu_torch.parallel import (  # noqa: E402
    build_parallel_engine, gather_state, make_mesh, multihost, shard_state,
)
from recmodels_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from recmodels_tpu_torch.train.engine import TrainState  # noqa: E402
from recmodels_tpu_torch.utils.config import TrainConfig  # noqa: E402
from recmodels_tpu_torch.utils.tree import leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 60  # the rendezvous and every collective
WORLD_TIMEOUT_S = 240  # a world that has not finished by then has hung


def start(mode: str, world: int, out_dir, *args) -> tuple:
    """Start the ``world`` ranks of ``mode`` on a free port, one torch
    thread each, their output to ``out_dir/rank<r>.log``; returns the
    handle ``finish`` takes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.makedirs(out_dir, exist_ok=True)
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r), str(world), str(port),
                               str(out_dir), *map(str, args)], cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"},
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    return procs, logs, str(out_dir), time.monotonic()


def finish(handle, expect_killed: bool = False) -> list:
    """Wait for a world (killing what is still running after
    ``WORLD_TIMEOUT_S`` from its start) and return each rank's results.
    Raises ``AssertionError`` with the ranks' log tails when a rank failed
    or hung; ``expect_killed``: kill what still runs without waiting and
    return the exit codes."""
    procs, logs, out_dir, t0 = handle
    for p in procs:
        try:
            p.wait(timeout=0.1 if expect_killed else max(1.0, WORLD_TIMEOUT_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            pass
    hung = [p for p in procs if p.poll() is None]
    for p in hung:
        p.kill()
        p.wait()
    for f in logs:
        f.close()
    codes = [p.returncode for p in procs]
    if expect_killed:
        return codes
    tails = "".join(open(os.path.join(out_dir, f"rank{r}.log")).read()[-2000:] for r in range(len(procs)))
    assert not hung and not any(codes), f"exit codes {codes}{' (hung, killed)' if hung else ''}\n{tails}"
    results = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))  # written by this world's ranks
        assert "error" not in results[-1], f"rank {r}: {results[-1]['error']}"
    return results


def arrays(state) -> list:
    """Every tensor of a state, as numpy arrays in a fixed order."""
    return [t.numpy().copy() for t in leaves(state._asdict())]


def load_state(path: str) -> TrainState:
    return TrainState(**torch.load(path, weights_only=True))


def trainer_cfg(**kw) -> TrainConfig:
    """``tests/test_multihost.py``'s configuration: FM, vocab 400, dim 8,
    32 examples a rank, capacity 4.0, one producer (no pool)."""
    base = dict(model="fm", vocab_size=400, embed_dim=8, batch_size=32, dense_lr=1e-2, emb_lr=5e-2,
                capacity_factor=4.0, seed=0, producer_workers=1)
    return TrainConfig(**{**base, **kw})


def run_steps(mesh, start: str) -> dict:
    sch = criteo_schema(vocab_size=400, embed_dim=8)
    eng = build_parallel_engine(build_model("fm", sch), mesh, emb_lr=5e-2, capacity_factor=4.0)
    state = shard_state(load_state(start), mesh)
    step = eng.jit_train_step()  # the per-rank form: this rank's own batch
    it = iter(SyntheticSource(sch, batch_size=32, seed=0, shard_index=mesh.rank, shard_count=mesh.size))
    losses = []
    for _ in range(3):
        b = next(it)
        state, m = step(state, *(torch.from_numpy(a) for a in (b.dense, b.ids, b.labels)))
        losses.append(m["loss"].item())
    return {"losses": losses}


class _RecordingWriter:
    """A stand-in for ``SummaryWriter``: one file a rank in the log dir."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"events.rank{multihost.host_shard()[0]}")
        open(self.path, "a").close()

    def add_scalar(self, tag, value, step):
        with open(self.path, "a") as f:
            f.write(f"{tag} {value} {step}\n")

    def close(self):
        pass


def run_trainer(mesh, start: str, ckpt: str, tb: str) -> dict:
    from recmodels_tpu_torch.train.loop import Trainer

    sys.modules["torch.utils.tensorboard"] = types.SimpleNamespace(SummaryWriter=_RecordingWriter)
    writes = []
    to_json = TrainConfig.to_json
    TrainConfig.to_json = lambda self: writes.append(1) or to_json(self)  # counts config.json writes
    cfg = trainer_cfg(steps=6, scan_steps=2, eval_every=3, eval_batches=2, log_every=2, ckpt_dir=ckpt,
                      ckpt_every=3, tb_dir=tb)
    tr = Trainer(cfg, device="cpu")
    tr.engine.init = lambda seed, device: load_state(start)
    final = tr.run()
    tr2 = Trainer(cfg, device="cpu")
    st2, data = tr2.ckpt.restore(tr2._shard(tr2.engine.init(seed=cfg.seed, device="cpu")))
    out = {"final": final, "state": arrays(tr.state), "restored": arrays(st2), "data": data,
           "config_writes": len(writes), "steps": tr.ckpt.all_steps()}

    # cursors that differ by rank: recorded one a rank, each rank's own back
    mgr = CheckpointManager(os.path.join(ckpt, "cursors"), mesh=mesh)
    mgr.save(1, tr.state, {"rows_consumed": 10 + mesh.rank})
    mgr.save(2, tr.state, {"rows_consumed": 20})
    mgr.wait()
    out["cursors"] = [mgr.restore(st2, step=s)[1] for s in (1, 2)]
    return out


def run_kill(mesh, ckpt: str, kill_at: int) -> dict:
    from recmodels_tpu_torch.train.loop import Trainer

    cfg = trainer_cfg(steps=8, scan_steps=1, eval_every=0, log_every=100, ckpt_dir=ckpt, ckpt_every=2)
    tr = Trainer(cfg, device="cpu")
    if kill_at and mesh.rank == 1:
        step, calls = tr.train_step, [0]

        def hooked(*args):
            if calls[0] == kill_at:
                os.kill(os.getpid(), signal.SIGKILL)
            calls[0] += 1
            return step(*args)

        tr.train_step = hooked
    tr.run()
    h = hashlib.sha256()
    for a in arrays(tr.state):
        h.update(a.tobytes())
    return {"step": int(tr.state.step), "hash": h.hexdigest()}


def run_geometry(mesh, src: str, dst: str, batch: str) -> dict:
    sch = criteo_schema(vocab_size=700, embed_dim=8)
    eng = build_parallel_engine(build_model("fm", sch), mesh, dense_lr=1e-2, emb_lr=5e-2, capacity_factor=4.0)
    target = shard_state(eng.init(seed=1, device="cpu"), mesh)
    state, data = CheckpointManager(src, mesh=mesh).restore_cross_geometry(target)
    with open(batch, "rb") as f:
        dense, ids = (torch.from_numpy(a) for a in pickle.load(f))  # written by the test
    per = ids.shape[0] // mesh.size
    block = slice(mesh.rank * per, (mesh.rank + 1) * per)
    with torch.no_grad():
        logits = eng.logits(state, dense[block], ids[block]).numpy().copy()
    out_mgr = CheckpointManager(dst, mesh=mesh)
    out_mgr.save(int(state.step), state, data, force=True)
    out_mgr.wait()
    gathered = gather_state(state, mesh)
    return {"logits": logits, "data": data, "restored_is_target": state is target, "step": int(state.step),
            "gathered": None if gathered is None else arrays(gathered)}


def main(argv) -> int:
    mode, rank, world, port, out_dir, args = argv[1], int(argv[2]), int(argv[3]), int(argv[4]), argv[5], argv[6:]
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=RANK_TIMEOUT_S)
    import torch.distributed as dist

    try:
        mesh = make_mesh(world)
        run = {"steps": run_steps, "trainer": run_trainer, "kill": run_kill, "geometry": run_geometry}[mode]
        try:
            result = run(mesh, *(int(a) if a.isdigit() else a for a in args))
        except Exception:  # reported to the test that owns the world
            result = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
