"""Several processes, one device each (port of
``recmodels_tpu/parallel/multihost.py``).

Each process runs the same program; ``initialize()`` joins them into one
``torch.distributed`` process group, whose mesh (``parallel/mesh.py``) the
sharded tables and steps then run over. A port process owns one device, so
it is the JAX package's "host" with one device: it reads its own shard of
the input (``host_shard()`` plugs into the sources' ``shard_index`` and
``shard_count``) and the primary (rank 0) alone writes logs, the run's
config and checkpoints.

Launch N processes with ``torchrun --nproc_per_node N -m
recmodels_tpu_torch.cli.train ...`` (the CLI calls ``initialize()``, which
reads torchrun's environment), or call ``initialize(address, N, rank)`` in
each process. As in the JAX package, a run that loses a process is resumed
from its last checkpoint, not continued with fewer.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# the rendezvous and every collective: a peer that does not come fails the
# run instead of hanging it
TIMEOUT_S = 300
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device="cuda", timeout_s: float = TIMEOUT_S) -> None:
    """Join this process into the default process group: rank
    ``process_id`` of ``num_processes``, meeting at ``coordinator_address``
    ("host:port", served by rank 0). The backend follows ``device``: NCCL
    for "cuda" (this process's card is ``LOCAL_RANK``, else the rank modulo
    the cards, made current), gloo for "cpu". Idempotent: a process already
    in a group returns at once.

    With no arguments it reads a launcher's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, as
    ``torchrun`` sets them); without one it returns and the process stays
    single, the counterpart of the JAX package's zero-config probe.

    Failure policy (the JAX package's): when the caller asked for a
    topology (any argument given, or more than one process), a group that
    cannot be formed within ``timeout_s`` raises ``RuntimeError``; a
    misconfigured launch never trains quietly on one shard of the data."""
    if dist.is_initialized():
        return
    env = os.environ
    launched = all(k in env for k in LAUNCHER_ENV)
    asked = coordinator_address is not None or process_id is not None or (num_processes or 0) > 1
    if not asked and not launched:
        return  # zero-config, no launcher: a single process
    if launched:  # what the caller left out, from the launcher
        if coordinator_address is None:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if num_processes is None:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None:
            process_id = int(env["RANK"])
    explicit = asked or num_processes > 1
    where = f"coordinator={coordinator_address}, n={num_processes}, id={process_id}, device={device}"
    try:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("the coordinator address, the process count and this process's id are all needed")
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("an NCCL group needs a CUDA device, and none is available")
            local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
            card = torch.device("cuda", local)
            torch.cuda.set_device(card)
            kw = dict(backend="nccl", device_id=card)
        elif device.type == "cpu":
            kw = dict(backend="gloo")
        else:
            raise ValueError(f"device {device}: the port's groups run on cuda (NCCL) or cpu (gloo)")
        dist.init_process_group(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                                rank=process_id, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    except (ValueError, RuntimeError) as e:  # torch's DistError and its kin are RuntimeErrors
        if explicit:
            raise RuntimeError(f"multi-process init failed for an explicitly requested topology ({where})") from e
        # a launcher's world of one that could not form: stay single, as the
        # JAX package's zero-config probe does


def host_shard() -> tuple[int, int]:
    """(shard_index, shard_count) of this process's data: (rank, world
    size), (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the process that writes logs, the run's config and
    checkpoints: rank 0, or a process without a group."""
    return host_shard()[0] == 0
