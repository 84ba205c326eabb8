"""Frozen dataclass run config and the schema it implies.

The JSON is the same as ``recmodels_tpu.utils.config.TrainConfig``'s, field
for field, so a ``model.json`` written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

from recmodels_tpu_torch.data.schema import Schema, criteo_schema


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # model
    model: str = "xdeepfm"
    hidden: tuple = (400, 400)
    cin_sizes: tuple = (128, 128)
    pnn_mode: str = "both"
    n_cross: int = 3
    attention_dim: int = 32
    bf16: bool = False
    # schema
    vocab_size: int = 100_000
    embed_dim: int = 16
    per_slot_dims: tuple | None = None  # overrides embed_dim when set
    # optimizers
    dense_optimizer: str = "adam"
    sparse_optimizer: str = "adagrad"
    dense_lr: float = 1e-3
    emb_lr: float = 1e-2
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_end_scale: float = 0.0
    dense_weight_decay: float = 0.0
    # data
    data: str = "synthetic"
    val_data: str | None = None
    batch_size: int = 8192
    shuffle_buffer: int = 0
    # schedule
    steps: int = 1000
    log_every: int = 50
    eval_every: int = 500
    eval_batches: int = 20
    # distribution
    n_devices: int | None = None
    capacity_factor: float = 1.25
    scan_steps: int = 1
    accum_steps: int = 1
    prefetch_batches: int = 2
    producer_workers: int = 0
    # io
    ckpt_dir: str | None = None
    ckpt_every: int = 1000
    tb_dir: str | None = None
    seed: int = 0

    def model_kwargs(self) -> dict:
        import torch

        kw = {}
        if self.model in ("deepfm", "pnn", "dcn", "xdeepfm", "widedeep", "nfm"):
            kw["hidden"] = tuple(self.hidden)
        if self.bf16 and self.model not in ("lr", "fm"):
            kw["compute_dtype"] = torch.bfloat16
        if self.model == "xdeepfm":
            kw["cin_sizes"] = tuple(self.cin_sizes)
        if self.model == "pnn":
            kw["mode"] = self.pnn_mode
        if self.model == "dcn":
            kw["n_cross"] = self.n_cross
        if self.model == "afm":
            kw["attention_dim"] = self.attention_dim
        return kw

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        d = json.loads(s)
        for k in ("hidden", "cin_sizes"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        if d.get("per_slot_dims") is not None:
            d["per_slot_dims"] = tuple(d["per_slot_dims"])
        return cls(**d)

    def apply_overrides(self, overrides: Sequence[str]) -> "TrainConfig":
        """'key=value' overrides with literal-eval'd values (a value that is
        no Python literal is a bare string); raises ``KeyError`` for an
        unknown key."""
        import ast

        d = dataclasses.asdict(self)
        for ov in overrides:
            k, _, v = ov.partition("=")
            if k not in d:
                raise KeyError(f"unknown config key: {k}")
            try:
                d[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                d[k] = v
        return TrainConfig.from_json(json.dumps(d, default=list))


def build_schema(cfg: TrainConfig) -> Schema:
    dims = list(cfg.per_slot_dims) if cfg.per_slot_dims else cfg.embed_dim
    return criteo_schema(vocab_size=cfg.vocab_size, embed_dim=dims)
