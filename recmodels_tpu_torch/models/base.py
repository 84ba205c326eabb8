"""Model abstraction (port of ``recmodels_tpu/models/base.py``): a CTR model
is a function of (dense features, embedded slots) -> logit. Embedding lookup
stays outside the model; a model declares the collections it needs with
``embedding_schemas()``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict

import torch

from recmodels_tpu_torch.data.schema import Schema

# {collection_name: [B, n_slots, dim]} activations
EmbActivations = Dict[str, torch.Tensor]


def wide_schema(schema: Schema) -> Schema:
    """The dim-1 'first order weight per bucket' companion schema."""
    return Schema(
        n_dense=schema.n_dense,
        slots=tuple(dataclasses.replace(s, embed_dim=1) for s in schema.slots),
    )


class CTRModel(abc.ABC):
    """A CTR model; subclasses hold only static config. Parameters live in
    plain dicts and lists of tensors, flattened in the JAX package's order
    by ``serve``."""

    name: str

    def __init__(self, schema: Schema):
        self.schema = schema

    @abc.abstractmethod
    def embedding_schemas(self) -> Dict[str, Schema]:
        """Collections this model needs, keyed by activation name."""

    @abc.abstractmethod
    def init_dense(self, generator: torch.Generator, device) -> Any:
        """Dense-tower params on ``device``, drawn from ``generator``."""

    @abc.abstractmethod
    def apply(self, params: Any, dense: torch.Tensor, emb: EmbActivations) -> torch.Tensor:
        """(dense [B, n_dense], emb activations) -> logits [B]."""


def flatten_slots(emb: torch.Tensor) -> torch.Tensor:
    """[B, F, D] -> [B, F*D] for MLP input."""
    return emb.reshape(emb.shape[0], -1)
