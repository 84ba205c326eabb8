"""What the two training kinds share: the first three steps through the
window's own call, and the reference's readings of the same steps.

The program's state is built once, driven from the seed through its first
steps and handed, the same object, to the window. Step 1 runs alone and
the state is read (``StepProbe.after_first``); steps 2 and 3 run and the
state is read again before step 4 (``after_third``). Each call is the
engine's captured scan, the call the window replays; a scan of K steps is
K replays of one graph, so K is no part of what is compared.
"""

from __future__ import annotations

import torch

from benchmark.gen import weights as W
from benchmark.reference import train as ref_train


def first_steps(scan, state, dense, ids, labels, probe) -> list:
    """Steps 1-3 on the first three batches (stacked [>=3, B, ...]); then
    the rest of the stack. Returns (the first three losses, the metrics of
    the whole stack as the scan gives them)."""
    _, m1 = scan(state, dense[0:1], ids[0:1], labels[0:1])
    probe.after_first(state)
    _, m2 = scan(state, dense[1:3], ids[1:3], labels[1:3])
    probe.after_third(state)
    parts = [m1["losses"], m2["losses"]]
    last = m2
    if dense.shape[0] > 3:
        _, last = scan(state, dense[3:], ids[3:], labels[3:])
        parts.append(last["losses"])
    losses = torch.cat(parts)
    return [float(x) for x in losses[:3]], {"loss": losses[-1], "losses": losses, "overflow": last["overflow"]}


def reference_readings(cfg: dict, seed: int, dense: torch.Tensor, ids: torch.Tensor, labels: torch.Tensor,
                       precision: str = "f32") -> dict:
    """The reference's readings of three steps from the benchmark's weights
    for ``seed``, on batches [3, B, ...] (slot-local ids), on their device;
    ``grad_table`` is (the rows' global ids, their first gradient)."""
    v, m = cfg["vocab_size"], cfg["n_slots"]
    gids = ids.long() + torch.arange(m, device=ids.device) * v
    uids, inv = torch.unique(gids, return_inverse=True)
    rows0 = W.initial_rows(cfg, seed, uids)
    dense_params = W.dense_weights(cfg, seed, ids.device)
    out = ref_train.readings(cfg, dense_params, rows0, inv.reshape(ids.shape), dense.float(), labels.float(),
                             precision)
    out["grad_table"] = (uids, out["grad_table"])
    return out


def unique_rows(ids: torch.Tensor, cfg: dict) -> int:
    """Distinct table rows of one batch [B, m] of slot-local ids."""
    gids = ids.long() + torch.arange(cfg["n_slots"], device=ids.device) * cfg["vocab_size"]
    return int(torch.unique(gids).numel())
