"""One rank of a gloo world that runs the port's sharded cases for
``tests/test_torch_sharded.py``; imports no JAX.

    python tests/torch_sharded_worker.py INPUTS RANK WORLD PORT OUT_DIR

INPUTS is a pickle the test wrote: {case name: {"spec": ..., "state": the
JAX start state as numpy arrays, "batches": [(dense, ids, labels), ...]}}
for the cases of this world. The rank joins the world at
``tcp://127.0.0.1:PORT``, runs every case on its sharded engine
(``build_parallel_engine`` + ``shard_state`` + the parallel steps) from the
given state and batches, and writes what each case produced to
``OUT_DIR/rank<RANK>.pkl``: its losses, overflow counts, AUC states,
gathered rows and this rank's block of the final state, as numpy arrays.
A failed case is written as its traceback.
"""

import datetime
import os
import pickle
import sys
import traceback

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recmodels_tpu_torch.data.schema import criteo_schema  # noqa: E402
from recmodels_tpu_torch.models import build_model  # noqa: E402
from recmodels_tpu_torch.parallel import (  # noqa: E402
    build_parallel_accum, build_parallel_engine, build_parallel_scan, build_parallel_steps, make_mesh,
    shard_state,
)
from recmodels_tpu_torch.serve import train_state_from_jax  # noqa: E402
from recmodels_tpu_torch.train.metrics import auc_init  # noqa: E402
from recmodels_tpu_torch.utils.tree import leaves  # noqa: E402

INIT_TIMEOUT_S = 60  # the world's rendezvous and every collective


def engine_of(spec: dict, mesh):
    """The sharded engine of a case's spec."""
    sch = criteo_schema(vocab_size=spec["vocab"], embed_dim=spec["dims"])
    model = build_model(spec["model"], sch, **spec["model_kw"])
    return build_parallel_engine(model, mesh, dense_lr=spec["dense_lr"], emb_lr=spec["emb_lr"],
                                 sparse_optimizer=spec["sparse_opt"], capacity_factor=spec["capacity"])


def global_state(engine, st: dict):
    """The engine's global padded state from the JAX start state's arrays."""
    return train_state_from_jax(engine, st["step"], st["dense"], adam=(st["count"], st["mu"], st["nu"]),
                                emb_tables=st["tables"], emb_opt=st["emb_opt"], device="cpu")


def arrays(state) -> dict:
    """This rank's state as numpy arrays: tables and sparse states by
    "coll/group[/name]", dense leaves in flatten order."""
    out = {"dense": [t.numpy().copy() for t in leaves(state.dense_params)]}
    for c, groups in state.emb_params.items():
        for g, t in groups.items():
            out[f"{c}/{g}"] = t.numpy().copy()
            for k, v in state.emb_opt[c][g].items():
                out[f"{c}/{g}/{k}"] = v.numpy().copy()
    return out


def run_case(spec: dict, st: dict, batches: list, mesh) -> dict:
    engine = engine_of(spec, mesh)
    state = shard_state(global_state(engine, st), mesh)
    tensors = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    kind = spec["kind"]
    out = {}
    if kind == "steps":
        train, _ = build_parallel_steps(engine, mesh)
        losses, overflows = [], []
        for b in tensors:
            state, m = train(state, *b)
            losses.append(m["loss"].item())
            overflows.append(int(m["overflow"]))
        out.update(losses=losses, overflows=overflows)
    elif kind == "scan":
        train, _ = build_parallel_steps(engine, mesh)
        stepwise = shard_state(global_state(engine, st), mesh)
        step_losses = []
        for b in tensors:
            stepwise, m = train(stepwise, *b)
            step_losses.append(m["loss"].item())
        state, m = build_parallel_scan(engine, mesh)(state, *(torch.stack(x) for x in zip(*tensors)))
        out.update(losses=m["losses"].tolist(), overflow=int(m["overflow"]), step_losses=step_losses,
                   stepwise=arrays(stepwise))
    elif kind == "accum":
        state, m = build_parallel_accum(engine, mesh)(state, *tensors[0])
        out.update(losses=[m["loss"].item()], overflows=[int(m["overflow"])])
    elif kind == "eval":
        _, evaluate = build_parallel_steps(engine, mesh)
        auc = auc_init(device="cpu")
        for b in tensors:
            evaluate(state, auc, *b)
        out["auc"] = [t.numpy().copy() for t in auc]
    elif kind == "overflow":
        dense, ids, _ = tensors[0]
        per = ids.shape[0] // mesh.size
        local = ids[mesh.rank * per:(mesh.rank + 1) * per]
        rows, overflow = engine.tables.gather_with_stats(state.emb_params, engine._group_ids(local))
        out.update(overflow=int(overflow), rows={c: {g: t.numpy().copy() for g, t in r.items()}
                                                 for c, r in rows.items()})
    else:
        raise ValueError(f"unknown case kind {kind!r}")
    out["state"] = arrays(state)
    return out


def main(argv) -> int:
    inputs, rank, world, port, out_dir = argv[1], int(argv[2]), int(argv[3]), int(argv[4]), argv[5]
    torch.set_num_threads(1)
    with open(inputs, "rb") as f:
        cases = pickle.load(f)  # written by the test in this run
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        mesh = make_mesh(world)
        results = {}
        for name, case in cases.items():
            try:
                results[name] = run_case(case["spec"], case["state"], case["batches"], mesh)
            except Exception:  # reported to the test that owns the case
                results[name] = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
