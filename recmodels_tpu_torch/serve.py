"""Model export and forward-only serving (port of ``recmodels_tpu/serve.py``).

The artifact is the JAX package's, so each package loads the other's:
  model.json — the run's ``TrainConfig`` JSON;
  params.npz — ``dense/<index>`` leaves in the JAX pytree flatten order
               (dict keys sorted, lists in order), ``emb/<collection>/<group>``
               canonical 2-D f32 tables, and the ``treedef`` string that the
               JAX loader checks.

Usage:
    from recmodels_tpu_torch.serve import load_predictor
    pred = load_predictor(model_dir)              # on the GPU
    probs = pred.predict_proba(dense, ids)        # any batch size
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.train.engine import Engine, TrainState, resolve_device
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema
from recmodels_tpu_torch.utils.tree import leaves, unflatten


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts, lists
    and leaves, which the JAX loader compares against its own model."""

    def fmt(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {fmt(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            return "[" + ", ".join(fmt(v) for v in t) + "]"
        return "*"

    return f"PyTreeDef({fmt(tree)})"


def export_model(out_dir: str, cfg: TrainConfig, engine: Engine, state: TrainState) -> None:
    """Write a serving artifact that either package loads."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = {
        f"dense/{i}": np.asarray(t.detach().cpu(), np.float32)
        for i, t in enumerate(leaves(state.dense_params))
    }
    for name, coll in engine.collections.items():
        for g in coll.groups:
            t = state.emb_params[name][g.name][: g.alloc_rows]
            arrays[f"emb/{name}/{g.name}"] = np.asarray(t.detach().cpu(), np.float32)
    np.savez(os.path.join(out_dir, "params.npz"), **arrays,
             treedef=np.array(treedef_str(state.dense_params)))
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        f.write(cfg.to_json())


def params_from_jax(engine: Engine, dense_leaves: Sequence[np.ndarray],
                    emb_tables: Mapping[str, np.ndarray], device="cuda") -> TrainState:
    """The port's parameters from the JAX package's, as numpy arrays:
    ``dense_leaves`` in JAX's flatten order (for xDeepFM: bias, cin_w/0,
    cin_w/1, mlp/i/b, mlp/i/w, w_cin, w_dense) and ``emb_tables`` keyed
    ``emb/<collection>/<group>``, canonical 2-D f32 (``params.npz``'s keys).

    Raises ``ValueError`` unless the leaf count and every shape match this
    engine's model."""
    device = resolve_device(device)
    template = engine.model.init_dense(torch.Generator().manual_seed(0), "cpu")
    want = [tuple(t.shape) for t in leaves(template)]
    got = [tuple(np.shape(a)) for a in dense_leaves]
    if got != want:
        raise ValueError(
            f"artifact/model structure mismatch:\n  artifact leaves {got}\n  model leaves    {want}"
        )
    tensors = (torch.tensor(np.asarray(a, np.float32), device=device) for a in dense_leaves)
    dense_params = unflatten(template, tensors)
    emb_params: dict[str, dict[str, torch.Tensor]] = {}
    for name, coll in engine.collections.items():
        emb_params[name] = {}
        for g in coll.groups:
            key = f"emb/{name}/{g.name}"
            t = np.asarray(emb_tables[key], np.float32)
            shape = (g.alloc_rows,) if g.dim == 1 else (g.alloc_rows, g.dim)
            if t.shape != shape:
                raise ValueError(f"artifact/model structure mismatch: {key} {t.shape}, expected {shape}")
            emb_params[name][g.name] = torch.tensor(t, device=device)
    return TrainState(step=0, dense_params=dense_params, emb_params=emb_params)


def train_state_from_jax(engine: Engine, step: int, dense_leaves: Sequence[np.ndarray],
                         adam: tuple, emb_tables: Mapping[str, np.ndarray],
                         emb_acc: Mapping[str, np.ndarray], device="cuda") -> TrainState:
    """The port's training state from a JAX ``TrainState`` of an engine with
    dense Adam and sparse Adagrad, as numpy arrays: ``step``, the dense
    leaves (as for ``params_from_jax``), ``adam`` = (count, mu leaves, nu
    leaves) of optax's ``ScaleByAdamState``, and per group the table and the
    Adagrad ``acc``, both keyed ``emb/<collection>/<group>``.

    Raises ``ValueError`` unless every shape matches this engine's model."""
    if engine.dense_optimizer != "adam" or engine.sparse_optimizer != "adagrad":
        raise ValueError("train_state_from_jax takes an engine with dense Adam and sparse Adagrad")
    state = params_from_jax(engine, dense_leaves, emb_tables, device)
    count, mu, nu = adam
    params = list(leaves(state.dense_params))
    moments = []
    for name, arrays in (("mu", mu), ("nu", nu)):
        if [tuple(np.shape(a)) for a in arrays] != [tuple(p.shape) for p in params]:
            raise ValueError(f"artifact/model structure mismatch: Adam {name} leaves")
        moments.append([torch.tensor(np.asarray(a, np.float32), device=p.device)
                        for a, p in zip(arrays, params)])
    emb_opt: dict[str, dict[str, Any]] = {}
    for name, coll in engine.collections.items():
        emb_opt[name] = {}
        for g in coll.groups:
            key = f"emb/{name}/{g.name}"
            acc = np.asarray(emb_acc[key], np.float32)
            table = state.emb_params[name][g.name]
            if acc.shape != tuple(table.shape):
                raise ValueError(f"artifact/model structure mismatch: {key} acc {acc.shape}")
            emb_opt[name][g.name] = {"acc": torch.tensor(acc, device=table.device)}
    return state._replace(
        step=int(step),
        dense_opt={"count": int(count), "mu": moments[0], "nu": moments[1]},
        emb_opt=emb_opt,
    )


class Predictor:
    """Forward-only scorer: numpy in, numpy out, any batch size."""

    def __init__(self, engine: Engine, state: TrainState, device: torch.device):
        self.engine = engine
        self.state = state
        self.device = device
        self._vocab = np.asarray(engine.model.schema.vocab_sizes, np.uint32)

    def predict_logits(self, dense, ids) -> np.ndarray:
        """Raises ``ValueError`` unless ``ids`` is [B, n_slots] with each id in
        [0, vocab_size) of its slot: the gather reads the row an id names and
        checks nothing, so an id out of range would read another slot's rows
        or memory past the table."""
        ids = np.asarray(ids, np.int32)
        if ids.ndim != 2 or ids.shape[1] != self._vocab.size:
            raise ValueError(f"ids must be [B, {self._vocab.size}], got {ids.shape}")
        # one unsigned compare: a negative id reads as >= 2^31
        bad = ids.view(np.uint32) >= self._vocab
        if bad.any():
            b, s = np.argwhere(bad)[0]
            raise ValueError(
                f"id {ids[b, s]} of example {b} is outside slot {s}'s vocab [0, {self._vocab[s]})"
            )
        dense_t = torch.as_tensor(np.asarray(dense, np.float32)).to(self.device)
        ids_t = torch.from_numpy(ids).to(self.device)
        with torch.inference_mode():
            out = self.engine.logits(self.state, dense_t, ids_t)
        return out.cpu().numpy()

    def predict_proba(self, dense, ids) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.predict_logits(dense, ids)))

    __call__ = predict_proba


def load_predictor(model_dir: str, device="cuda") -> Predictor:
    """Rebuild the model from an artifact (the JAX package's or this one's)
    and return a scorer on ``device``; raises if ``device`` is CUDA and no
    card is present."""
    device = resolve_device(device)
    with open(os.path.join(model_dir, "model.json")) as f:
        cfg = TrainConfig.from_json(f.read())
    model = build_model(cfg.model, build_schema(cfg), **cfg.model_kwargs())
    engine = Engine(model)
    with np.load(os.path.join(model_dir, "params.npz")) as data:
        n_dense = sum(1 for k in data.files if k.startswith("dense/"))
        leaves = [data[f"dense/{i}"] for i in range(n_dense)]
        tables: dict[str, Any] = {k: data[k] for k in data.files if k.startswith("emb/")}
    state = params_from_jax(engine, leaves, tables, device)
    return Predictor(engine, state, device)
