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

CLI: ``python -m recmodels_tpu_torch.cli.export --ckpt-dir runs/x --out
artifacts/x`` (``export_from_checkpoint``), then ``python -m
recmodels_tpu_torch.cli.predict --model-dir artifacts/x --data test.tsv``.

The Predictor pads each request to a power-of-two bucket from ``min_bucket``
(256), as the JAX package's does; on the card each bucket's ``Engine.logits``
is a CUDA graph, captured at the bucket's first request and replayed after.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.train.capture import capture, warm_up
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


def _dense_template(engine: Engine):
    """The engine's model's dense parameters on the CPU, from a fixed seed:
    the tree and shapes an artifact's dense leaves must have."""
    return engine.model.init_dense(torch.Generator().manual_seed(0), "cpu")


def params_from_jax(engine: Engine, dense_leaves: Sequence[np.ndarray],
                    emb_tables: Mapping[str, np.ndarray], device="cuda") -> TrainState:
    """The port's parameters from the JAX package's, as numpy arrays:
    ``dense_leaves`` in JAX's flatten order (dict keys sorted, lists in
    order: the order of ``utils.tree.leaves`` over the model's
    ``init_dense``; for DCN: bias, cross/b, cross/w, mlp/i/b, mlp/i/w,
    w_out) and ``emb_tables`` keyed ``emb/<collection>/<group>`` as
    ``params.npz`` holds them: f32 ``[rows, dim]``, and ``[rows]`` for a
    dim-1 group (LR's only table, ``emb/wide/d1``). The engine's collections
    name the keys: ``emb/emb/d17`` for a fused table, ``emb/emb/d16`` for
    PNN's and DCN's.

    Raises ``ValueError`` unless the leaf count and every shape match this
    engine's model."""
    device = resolve_device(device)
    template = _dense_template(engine)
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
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                      dense_params=dense_params, emb_params=emb_params)


class _AdamState(NamedTuple):
    """(count, mu, nu): the fields of optax's ``ScaleByAdamState``."""

    count: Any
    mu: Any
    nu: Any


def _optax_nodes(tree) -> list:
    """The optimizer states in an optax state tree, in chain order, as
    (kind, fields): ``adam`` (``ScaleByAdamState``: count, mu, nu), ``rss``
    (``ScaleByRssState``: sum_of_squares) and ``schedule``
    (``ScaleByScheduleState``: count); states without fields (optax's
    ``EmptyState``: a float lr, ``add_decayed_weights`` at a fixed rate,
    sgd's identity) hold nothing and are skipped. Read by their fields, as
    namedtuples, so the optax classes are not needed here."""
    fields = getattr(tree, "_fields", None)
    if fields is None:
        return [node for t in tree for node in _optax_nodes(t)] if isinstance(tree, tuple) else []
    kinds = {("count", "mu", "nu"): "adam", ("sum_of_squares",): "rss", ("count",): "schedule"}
    if not fields:
        return []
    if tuple(fields) not in kinds:
        raise ValueError(f"artifact/model structure mismatch: unknown optimizer state {type(tree).__name__}"
                         f"{tuple(fields)}")
    return [(kinds[tuple(fields)], tree)]


def _dense_opt_from_jax(engine: Engine, params: list, dense_opt, device) -> dict:
    """The engine's dense optimizer state from optax's state tree (leaves
    as numpy arrays): adam, adamw, adagrad or sgd, each with or without a
    schedule and with or without decay."""
    nodes = _optax_nodes(dense_opt)
    want = {"adam": ["adam"], "adagrad": ["rss"], "sgd": []}[engine.dense_optimizer]
    want = want + (["schedule"] if engine.dense_tx.scheduled else [])
    if [k for k, _ in nodes] != want:
        raise ValueError(f"artifact/model structure mismatch: optimizer states {[k for k, _ in nodes]}, "
                         f"the engine's dense {engine.dense_optimizer!r} keeps {want}")

    def like_params(name, arrays):
        arrays = list(leaves(arrays))
        if [tuple(np.shape(a)) for a in arrays] != [tuple(p.shape) for p in params]:
            raise ValueError(f"artifact/model structure mismatch: {name} leaves")
        return [torch.tensor(np.asarray(a, np.float32), device=p.device) for a, p in zip(arrays, params)]

    def count(x):
        return torch.tensor(int(x), dtype=torch.int32, device=device)

    out = {}
    for kind, node in nodes:
        if kind == "adam":
            out.update(count=count(node.count), mu=like_params("Adam mu", node.mu),
                       nu=like_params("Adam nu", node.nu))
        elif kind == "rss":
            out["sum_of_squares"] = like_params("Adagrad sum_of_squares", node.sum_of_squares)
        else:
            out["schedule_count"] = count(node.count)
    return out


def train_state_from_jax(engine: Engine, step: int, dense_leaves: Sequence[np.ndarray],
                         adam: tuple | None = None, emb_tables: Mapping[str, np.ndarray] | None = None,
                         emb_acc: Mapping[str, np.ndarray] | None = None, device="cuda", *,
                         emb_opt: Mapping[str, Mapping[str, np.ndarray]] | None = None,
                         dense_opt=None) -> TrainState:
    """The port's training state from a JAX ``TrainState``, as numpy arrays:
    ``step``, the dense leaves (as for ``params_from_jax``), the dense
    optimizer's state, the tables keyed ``emb/<collection>/<group>``, and
    per group the sparse optimizer's state under the same keys.

    The dense optimizer's state comes as ``dense_opt``, the JAX state's
    optax tree with numpy leaves (``jax.device_get(state).dense_opt``) for
    any dense optimizer the engine builds: adam or adamw, adagrad or sgd
    with or without ``add_decayed_weights``, each with a schedule's count
    when the engine has ``dense_lr_schedule``; or, for an engine with dense
    Adam at a constant lr, as ``adam`` = (count, mu leaves, nu leaves) of
    optax's ``ScaleByAdamState``. ``emb_opt`` maps each table's key to the
    group's state dict ({"acc": ...} for Adagrad, {"m": ..., "v": ...} for
    lazy or dense Adam); ``emb_acc`` = {key: acc} says the same for Adagrad.

    Raises ``ValueError`` unless the optimizer states are the engine's and
    every shape matches this engine's model."""
    if (adam is None) == (dense_opt is None):
        raise ValueError("train_state_from_jax takes one of adam and dense_opt")
    if adam is not None:
        if engine.dense_optimizer != "adam" or engine.dense_tx.scheduled:
            raise ValueError("train_state_from_jax takes adam for an engine with dense Adam "
                             "at a constant lr; pass dense_opt")
        count, mu, nu = adam
        dense_opt = (_AdamState(count, mu, nu),)
    if emb_tables is None:
        raise ValueError("train_state_from_jax takes emb_tables")
    if (emb_acc is None) == (emb_opt is None):
        raise ValueError("train_state_from_jax takes one of emb_opt and emb_acc")
    if emb_acc is not None:
        emb_opt = {key: {"acc": acc} for key, acc in emb_acc.items()}
    names = sorted(engine.sparse_opt.init(1, 1))
    state = params_from_jax(engine, dense_leaves, emb_tables, device)
    opt = _dense_opt_from_jax(engine, list(leaves(state.dense_params)), dense_opt, state.step.device)
    out: dict[str, dict[str, Any]] = {}
    for name, coll in engine.collections.items():
        out[name] = {}
        for g in coll.groups:
            key = f"emb/{name}/{g.name}"
            group_state = emb_opt.get(key, {})
            if sorted(group_state) != names:
                raise ValueError(
                    f"artifact/model structure mismatch: {key} optimizer state {sorted(group_state)}, "
                    f"the engine's {engine.sparse_optimizer!r} keeps {names}"
                )
            table = state.emb_params[name][g.name]
            tensors = {}
            for k, a in group_state.items():
                a = np.asarray(a, np.float32)
                if a.shape != tuple(table.shape):
                    raise ValueError(f"artifact/model structure mismatch: {key} {k} {a.shape}")
                tensors[k] = torch.tensor(a, device=table.device)
            out[name][g.name] = tensors
    return state._replace(
        step=torch.tensor(int(step), dtype=torch.int32, device=state.step.device),
        dense_opt=opt, emb_opt=out,
    )


def export_from_checkpoint(ckpt_dir: str, out_dir: str, device="cuda") -> None:
    """Restore the latest training checkpoint of ``ckpt_dir`` (its
    ``config.json`` names the model) on ``device`` and export it for
    serving."""
    from recmodels_tpu_torch.train.loop import Trainer

    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = TrainConfig.from_json(f.read())
    cfg = cfg.apply_overrides([f"ckpt_dir={ckpt_dir!r}", "tb_dir=None"])
    trainer = Trainer(cfg, device=device)
    state = trainer.engine.init(seed=cfg.seed, device=trainer.device)
    state, _ = trainer.ckpt.restore(state)
    export_model(out_dir, cfg, trainer.engine, state)


class _Bucket:
    """One bucket's static inputs, its graph and the graph's logits."""

    def __init__(self, dense: torch.Tensor, ids: torch.Tensor):
        self.dense, self.ids = dense, ids
        self.graph = None
        self.out = None


class Predictor:
    """Forward-only scorer: numpy in, numpy out, any batch size.

    Each request is padded with zero rows to a power-of-two bucket from
    ``min_bucket`` (the JAX package's buckets, so the number of shapes stays
    logarithmic) and the padded rows are sliced off the output. On the card
    each bucket's ``Engine.logits`` is captured as a CUDA graph at its first
    request (after one eager run on a side stream) and replayed; the bucket
    graphs share one memory pool, as they never run at once, and read the
    tensors of the state they captured, so assigning another ``state``
    drops them. On the CPU the padded request runs eagerly."""

    def __init__(self, engine: Engine, state: TrainState, device: torch.device,
                 min_bucket: int = 256):
        self.engine = engine
        self.state = state
        self.device = device
        self.min_bucket = min_bucket
        self._vocab = np.asarray(engine.model.schema.vocab_sizes, np.uint32)
        self._buckets: dict[int, _Bucket] = {}
        self._graph_state = state  # the state the bucket graphs read
        self._pool = None
        self._stream = None

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return b

    def _logits(self, dense: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.engine.logits(self.state, dense, ids)

    def _replay(self, dense: np.ndarray, ids: np.ndarray) -> torch.Tensor:
        """The logits of one padded request from its bucket's graph (the
        graph's static output: read it before the next request)."""
        if self.state is not self._graph_state:
            self._buckets.clear()
            self._pool = None
            self._graph_state = self.state
        b = dense.shape[0]
        bucket = self._buckets.get(b)
        if bucket is None:
            bucket = self._buckets[b] = _Bucket(
                torch.empty(dense.shape, dtype=torch.float32, device=self.device),
                torch.empty(ids.shape, dtype=torch.int32, device=self.device))
        bucket.dense.copy_(torch.from_numpy(dense))
        bucket.ids.copy_(torch.from_numpy(ids))
        if bucket.graph is None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            run = lambda: self._logits(bucket.dense, bucket.ids)  # noqa: E731
            warm_up(run, self._stream)
            with torch.inference_mode():
                bucket.graph, bucket.out = capture(run, self._pool, self._stream)
            self._pool = bucket.graph.pool()
        bucket.graph.replay()
        return bucket.out

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
        dense = np.asarray(dense, np.float32)
        n = ids.shape[0]
        pad = self._bucket(n) - n
        if pad:
            dense = np.concatenate([dense, np.zeros((pad,) + dense.shape[1:], dense.dtype)])
            ids = np.concatenate([ids, np.zeros((pad,) + ids.shape[1:], ids.dtype)])
        if self.device.type == "cuda":
            out = self._replay(dense, ids)
        else:
            out = self._logits(torch.from_numpy(dense).to(self.device),
                               torch.from_numpy(ids).to(self.device))
        return out[:n].cpu().numpy()

    def predict_proba(self, dense, ids) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.predict_logits(dense, ids)))

    __call__ = predict_proba


def load_predictor(model_dir: str, min_bucket: int = 256, device="cuda") -> Predictor:
    """Rebuild the model from an artifact (the JAX package's or this one's)
    and return a scorer on ``device`` with buckets from ``min_bucket``;
    raises if ``device`` is CUDA and no card is present, and ``ValueError``
    when the artifact's ``treedef`` is not the model's (as the JAX loader
    does)."""
    device = resolve_device(device)
    with open(os.path.join(model_dir, "model.json")) as f:
        cfg = TrainConfig.from_json(f.read())
    model = build_model(cfg.model, build_schema(cfg), **cfg.model_kwargs())
    engine = Engine(model)
    with np.load(os.path.join(model_dir, "params.npz")) as data:
        stored, model_tree = str(data["treedef"]), treedef_str(_dense_template(engine))
        if stored != model_tree:
            raise ValueError(
                f"artifact/model structure mismatch:\n  artifact {stored}\n  model    {model_tree}"
            )
        n_dense = sum(1 for k in data.files if k.startswith("dense/"))
        leaves = [data[f"dense/{i}"] for i in range(n_dense)]
        tables: dict[str, Any] = {k: data[k] for k in data.files if k.startswith("emb/")}
    state = params_from_jax(engine, leaves, tables, device)
    return Predictor(engine, state, device, min_bucket)
