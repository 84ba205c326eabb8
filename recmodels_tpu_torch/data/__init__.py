from recmodels_tpu_torch.data.schema import FeatureSpec, Schema, criteo_schema
from recmodels_tpu_torch.data.hashing import hash_tokens, splitmix64
from recmodels_tpu_torch.data.criteo import (
    Batch, CriteoTSVSource, SyntheticSource, make_batch_iterator, parse_criteo_batch, parse_criteo_lines,
    transform_dense,
)

__all__ = [
    "FeatureSpec",
    "Schema",
    "criteo_schema",
    "hash_tokens",
    "splitmix64",
    "Batch",
    "CriteoTSVSource",
    "SyntheticSource",
    "make_batch_iterator",
    "parse_criteo_batch",
    "parse_criteo_lines",
    "transform_dense",
]
