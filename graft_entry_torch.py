"""The port's counterpart of ``__graft_entry__.py``: a single-device compile
check and a multi-device dry run, on the CUDA card by default.

``entry()`` returns the flagship's forward (``Engine.logits`` of bf16
xDeepFM, the BASELINE.json configuration at compile-check size) with
example arguments. ``dryrun_multichip(n)`` starts ``n`` processes, one
device each, in one process group and runs ONE full sharded training step
on tiny shapes: row-sharded tables, the all-to-all id, row and grad
exchange, the mean of the dense grads over the ranks and the sharded
sparse update.

    python -c "import graft_entry_torch as g; g.dryrun_multichip(2, device='cpu')"   # gloo

A rank of the dry run is this file run as a script (``python
graft_entry_torch.py RANK N PORT DEVICE``); it prints its loss as JSON.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DRYRUN_TIMEOUT_S = 300  # the whole dry run, the ranks' start included
RANK_TIMEOUT_S = 120  # a rank's rendezvous and every collective


def _example_batch(schema, batch: int, device, seed: int = 0):
    from recmodels_tpu_torch.data import SyntheticSource

    b = next(iter(SyntheticSource(schema, batch_size=batch, seed=seed)))
    return tuple(torch.as_tensor(a, device=device) for a in (b.dense, b.ids, b.labels))


def entry(device="cuda"):
    """(forward, example_args): ``forward(state, dense, ids)`` is
    ``Engine.logits`` of bf16 xDeepFM at vocab 10,000, dim 16, CIN(128,128),
    DNN(400,400) (``__graft_entry__.py``'s sizes), the state drawn from seed
    0 and a batch of 256 from ``SyntheticSource``, on ``device``."""
    from recmodels_tpu_torch.data import criteo_schema
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.engine import Engine

    schema = criteo_schema(vocab_size=10_000, embed_dim=16)
    model = build_model("xdeepfm", schema, cin_sizes=(128, 128), hidden=(400, 400), compute_dtype=torch.bfloat16)
    engine = Engine(model)
    state = engine.init(seed=0, device=device)
    dense, ids, _ = _example_batch(schema, 256, state.step.device)

    def forward(state, dense, ids):
        return engine.logits(state, dense, ids)

    return forward, (state, dense, ids)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One full sharded train step over ``n_devices`` processes (NCCL on
    ``"cuda"``, one card each; gloo on ``"cpu"``) at vocab 512, dim 8,
    CIN(16,16), DNN(32,), capacity factor 4.0 and a global batch of 8 per
    rank. Raises ``RuntimeError`` when the host has fewer cards than ranks,
    a rank fails or the run outlasts ``DRYRUN_TIMEOUT_S``, and
    ``AssertionError`` for a non-finite loss; prints
    ``dryrun_multichip(n): ok, loss=...``."""
    from recmodels_tpu_torch.train.engine import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} cards; this host has "
                           f"{torch.cuda.device_count()}")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    if device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(n_devices), str(port),
                               device.type], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(n_devices)]
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"dryrun_multichip({n_devices}): a rank ran past {DRYRUN_TIMEOUT_S} s") from None
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [line for line in out.splitlines() if line.startswith("{")]
        if p.returncode or not lines:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank {r} exited {p.returncode}:\n{out[-3000:]}")
        losses.append(json.loads(lines[-1])["loss"])
    loss = losses[0]
    assert math.isfinite(loss), f"non-finite loss {loss}"
    assert all(x == loss for x in losses), f"the ranks' losses differ: {losses}"
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.4f}")


def _rank(rank: int, world: int, port: int, device: str) -> None:
    """One rank of ``dryrun_multichip``: join the group, take one sharded
    step on the global batch, print {"rank", "loss"}."""
    import torch.distributed as dist

    from recmodels_tpu_torch.data import criteo_schema
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.parallel import (
        build_parallel_engine, build_parallel_steps, initialize, make_mesh, shard_state,
    )

    if device == "cpu":
        torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", world, rank, device=device, timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = make_mesh(world)
        schema = criteo_schema(vocab_size=512, embed_dim=8)
        model = build_model("xdeepfm", schema, cin_sizes=(16, 16), hidden=(32,))
        engine = build_parallel_engine(model, mesh, capacity_factor=4.0)
        state = shard_state(engine.init(seed=0, device=mesh.device), mesh)
        train_step, _ = build_parallel_steps(engine, mesh)
        state, metrics = train_step(state, *_example_batch(schema, 8 * world, mesh.device))
        print(json.dumps({"rank": rank, "loss": metrics["loss"].item()}), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
