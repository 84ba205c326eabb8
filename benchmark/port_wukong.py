"""The benchmark's door into the program for the Wukong configuration: build
its engine from the configuration, make the benchmark's weights for a seed
and write them into its state. The table, its pooled bags, both Adagrads and
what the check reads of the state (``port_multihot.StepProbe``) are
DLRM-DCNv2's (``port_multihot.py``, ``gen/multihot.py``).

The program's parameter layouts are the reference's (``[in, out]``, the
flatten names ``layers.i.fm_y``, ``layers.i.mlp.j.w``, ...), so weights
cross as they are.
"""

from __future__ import annotations

import torch

from benchmark.gen import multihot as W
from benchmark.gen import zipf
from benchmark.port import dense_leaves, table_of
from benchmark.port_multihot import StepProbe  # noqa: F401  (the check's readings, as DLRM-DCNv2's)


def build_engine(cfg: dict):
    from recmodels_tpu_torch.data.schema import criteo_schema
    from recmodels_tpu_torch.models import build_model
    from recmodels_tpu_torch.train.engine import Engine

    schema = criteo_schema(vocab_size=list(cfg["num_embeddings_per_feature"]), embed_dim=cfg["embed_dim"],
                           hotness=list(cfg["hotness"]))
    model = build_model(cfg["model"], schema, bottom=tuple(cfg["bottom"]), top=tuple(cfg["top"]),
                        n_layers=cfg["n_layers"], n_fmb=cfg["n_fmb"], n_lcb=cfg["n_lcb"], fm_rank=cfg["fm_rank"],
                        fmb_hidden=tuple(cfg["fmb_hidden"]), compute_dtype=getattr(torch, cfg["compute_dtype"]))
    return Engine(model, dense_optimizer=cfg["dense_optimizer"], sparse_optimizer=cfg["sparse_optimizer"],
                  dense_lr=cfg["dense_lr"], emb_lr=cfg["emb_lr"])


def dense_weights(cfg: dict, seed: int, device) -> dict:
    """Every parameter but the table, by name, f32 on ``device``
    (``reference/wukong.init``), from the seed's stream of DLRM-DCNv2's
    dense weights."""
    from benchmark.reference import wukong

    g = zipf.generator(seed, device, 4)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32) * std

    return wukong.init(cfg, randn)


@torch.no_grad()
def write_weights(state, cfg: dict, seed: int) -> None:
    """The benchmark's weights for ``seed`` into the program's state, in
    place."""
    W.fill_table(table_of(state), cfg, seed)
    ref = dense_weights(cfg, seed, table_of(state).device)
    prog = dense_leaves(state)
    if set(prog) != set(ref):
        raise ValueError(f"the program's parameters {sorted(prog)} are not the reference's {sorted(ref)}")
    for name, t in prog.items():
        t.copy_(ref[name])


def train_state(engine, cfg: dict, seed: int, device):
    state = engine.init(seed=0, device=device)
    write_weights(state, cfg, seed)
    return state
