"""The benchmark's one door into the program (``recmodels_tpu_torch``): build
its engine, Trainer and scorer from a configuration, write the benchmark's
weights into its state, and read from its state what the check compares.

Layouts are the program's and are converted here: the fused table ``[rows,
D + 1]`` (the wide weight last) in this file, each model family's own
layouts in ``adapters/<model>.py`` (a new family adds a file).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

from benchmark.gen import weights as W

EPS_ADAGRAD = 1e-8
_ADAPTERS: dict = {}


def _pkg():
    import recmodels_tpu_torch as pkg  # noqa: F401  (the program under test)
    from recmodels_tpu_torch.data.schema import criteo_schema
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.engine import Engine, TrainState

    return criteo_schema, build_model, Engine, TrainState


def adapter(cfg: dict):
    """The configuration's model family on the program's side
    (``adapters/<model>.py``): ``model_kwargs(cfg)`` and ``to_program(cfg,
    name, w)``, a reference-named weight in the program's layout."""
    name = cfg["model"]
    if name not in _ADAPTERS:
        path = Path(__file__).resolve().parent / "adapters" / f"{name}.py"
        if not path.exists():
            raise ValueError(f"no adapter for model {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(f"bench_adapter_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _ADAPTERS[name] = mod
    return _ADAPTERS[name]


def model_kwargs(cfg: dict) -> dict:
    return {"hidden": tuple(cfg["hidden"]), "compute_dtype": getattr(torch, cfg["compute_dtype"]),
            **adapter(cfg).model_kwargs(cfg)}


def build_engine(cfg: dict):
    criteo_schema, build_model, Engine, _ = _pkg()
    schema = criteo_schema(vocab_size=cfg["vocab_size"], embed_dim=cfg["embed_dim"])
    model = build_model(cfg["model"], schema, **model_kwargs(cfg))
    return Engine(model, dense_optimizer="adam", sparse_optimizer="adagrad",
                  dense_lr=cfg["dense_lr"], emb_lr=cfg["emb_lr"])


def trainer_config(cfg: dict, data: str, seed: int, steps: int, scan_steps: int):
    """The Trainer's config for ``cfg`` on the TSV ``data``: no eval, no
    checkpoints, a log (the host's sync) every superbatch, the default
    producer."""
    from recmodels_tpu_torch.utils.config import TrainConfig

    return TrainConfig(model=cfg["model"], hidden=tuple(cfg["hidden"]),
                       cin_sizes=tuple(cfg.get("cin_sizes", (128, 128))),
                       bf16=cfg["compute_dtype"] == "bfloat16", vocab_size=cfg["vocab_size"],
                       embed_dim=cfg["embed_dim"], dense_optimizer="adam", sparse_optimizer="adagrad",
                       dense_lr=cfg["dense_lr"], emb_lr=cfg["emb_lr"], data=data,
                       batch_size=cfg["batch_size"], steps=steps, log_every=scan_steps, eval_every=0,
                       scan_steps=scan_steps, seed=seed % (1 << 31))


def table_of(state) -> torch.Tensor:
    (table,) = state.emb_params["emb"].values()
    return table


def acc_of(state) -> torch.Tensor:
    (group,) = state.emb_opt["emb"].values()
    return group["acc"]


def _names(tree, prefix=""):
    """Leaf names in the program's flatten order (dict keys sorted, lists in
    order), ``cin_w.k`` named ``cin.k``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _names(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1].replace("cin_w.", "cin.")


def dense_leaves(state) -> dict:
    from recmodels_tpu_torch.utils.tree import leaves

    return dict(zip(_names(state.dense_params), leaves(state.dense_params)))


@torch.no_grad()
def write_weights(state, cfg: dict, seed: int) -> None:
    """The benchmark's weights for ``seed`` into the program's state, in
    place."""
    W.fill_table(table_of(state), cfg, seed)
    ref = W.dense_weights(cfg, seed, table_of(state).device)
    prog = dense_leaves(state)
    if set(prog) != set(ref):
        raise ValueError(f"the program's parameters {sorted(prog)} are not the reference's {sorted(ref)}")
    for name, t in prog.items():
        t.copy_(adapter(cfg).to_program(cfg, name, ref[name]))


def program_layout(cfg: dict, readings: dict) -> dict:
    """The reference's ``readings`` with its dense gradients in the
    program's layouts (each a permutation of the reference's), to be set
    beside the program's."""
    conv = adapter(cfg).to_program
    return {**readings, "grad_vec": {k: conv(cfg, k, g) for k, g in readings["grad_vec"].items()}}


def train_state(engine, cfg: dict, seed: int, device):
    """A training state (parameters, dense Adam, sparse Adagrad) holding the
    benchmark's weights."""
    state = engine.init(seed=0, device=device)
    write_weights(state, cfg, seed)
    return state


def serve_state(engine, cfg: dict, seed: int, device):
    """A serving state (parameters only) holding the benchmark's weights."""
    _, _, _, TrainState = _pkg()
    gen = torch.Generator(device=device).manual_seed(0)
    state = TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                       dense_params=engine.model.init_dense(gen, device),
                       emb_params=engine.tables.init_params(gen, device))
    write_weights(state, cfg, seed)
    return state


def predictor(engine, state, device):
    from recmodels_tpu_torch.serve import Predictor

    return Predictor(engine, state, torch.device(device))


def trainer(tcfg, logger, device):
    from recmodels_tpu_torch.train.loop import Trainer

    return Trainer(tcfg, logger=logger, device=device)


def logger_base():
    from recmodels_tpu_torch.utils.logging import MetricsLogger

    return MetricsLogger


def tsv_source(cfg: dict, path: str):
    from recmodels_tpu_torch.data.criteo import CriteoTSVSource
    from recmodels_tpu_torch.data.schema import criteo_schema

    schema = criteo_schema(vocab_size=cfg["vocab_size"], embed_dim=cfg["embed_dim"])
    return CriteoTSVSource(path, schema, cfg["batch_size"], loop=True)


class StepProbe:
    """What the check reads of the program's first steps, from its state:

    * after step 1, each leaf's first gradient as the optimizer got it
      (``grad_vec``, and its norm in ``grad``): dense Adam's ``mu / (1 -
      b1)``; for the table (``grad_table``: the moved rows' global ids and
      their gradient), from Adagrad's move ``w1 - w0 = -lr g / (sqrt(acc1)
      + eps)``, so ``g = (w0 - w1) (sqrt(acc1) + eps) / lr`` (``acc1``
      alone cannot resolve a gradient whose square is under an ulp of its
      initial 0.1);
    * after step 3, before step 4, the norm of each leaf's change since the
      start.

    The initial table is made again slot by slot from the seed
    (``weights.table_chunk``), so no copy of it is held."""

    def __init__(self, state, cfg: dict, seed: int):
        self.cfg, self.seed = cfg, seed
        self.start = {k: v.detach().clone() for k, v in dense_leaves(state).items()}
        self.grad = self.grad_vec = self.grad_table = self.change = None

    def _table_sums(self, table: torch.Tensor, fn, keep=None) -> dict:
        """Norms of ``fn``'s rows over the table; ``keep(first_row, x)`` sees
        each slot's rows."""
        cfg, v, d = self.cfg, self.cfg["vocab_size"], self.cfg["embed_dim"]
        emb = wide = torch.zeros((), dtype=torch.float64, device=table.device)
        for s in range(cfg["n_slots"]):
            x = fn(s, table[s * v:(s + 1) * v], W.table_chunk(cfg, self.seed, s, table.device)).double()
            emb = emb + (x[:, :d] ** 2).sum()
            wide = wide + (x[:, d] ** 2).sum()
            if keep is not None:
                keep(s * v, x)
        tail = table[W.n_rows(cfg):].double()  # rows no slot owns: they must stay 0
        emb = emb + (tail[:, :d] ** 2).sum()
        wide = wide + (tail[:, d] ** 2).sum()
        if keep is not None:
            keep(W.n_rows(cfg), tail)
        return {"table.emb": float(emb.sqrt()), "table.wide": float(wide.sqrt())}

    @torch.no_grad()
    def after_first(self, state) -> None:
        table, acc, v = table_of(state), acc_of(state), self.cfg["vocab_size"]
        lr = self.cfg["emb_lr"]
        ids, rows = [], []

        def keep(first_row: int, g: torch.Tensor) -> None:
            moved = torch.nonzero(g.ne(0).any(dim=1)).flatten()
            ids.append(moved + first_row)
            rows.append(g[moved].float())

        grads = self._table_sums(
            table, lambda s, w1, w0: (w0 - w1) * (torch.sqrt(acc[s * v:(s + 1) * v]) + EPS_ADAGRAD) / lr, keep)
        self.grad_table = (torch.cat(ids), torch.cat(rows))
        mu = dict(zip(dense_leaves(state), state.dense_opt["mu"]))
        self.grad_vec = {name: t.float() / (1.0 - 0.9) for name, t in mu.items()}
        for name, t in self.grad_vec.items():
            grads[name] = float(torch.linalg.vector_norm(t.double()))
        self.grad = grads

    @torch.no_grad()
    def after_third(self, state) -> None:
        change = self._table_sums(table_of(state), lambda s, w3, w0: w3 - w0)
        for name, t in dense_leaves(state).items():
            change[name] = float(torch.linalg.vector_norm((t - self.start[name]).double()))
        self.change = change

    def readings(self, losses: list) -> dict:
        """The program's side of the check, in ``check.train_numbers``' form."""
        return {"loss": losses, "grad": self.grad, "grad_vec": self.grad_vec, "grad_table": self.grad_table,
                "change": self.change}
