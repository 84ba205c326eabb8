"""The port's data layer and config against the JAX package's: the same seeds
and inputs give byte-identical arrays, and config JSON round-trips both ways."""

import dataclasses

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from recmodels_tpu.data import criteo as jcriteo
from recmodels_tpu.data import hashing as jhashing
from recmodels_tpu.data import schema as jschema
from recmodels_tpu.train.loop import build_schema as jbuild_schema
from recmodels_tpu.utils.config import TrainConfig as JConfig
from recmodels_tpu_torch.data import criteo as tcriteo
from recmodels_tpu_torch.data import hashing as thashing
from recmodels_tpu_torch.data import schema as tschema
from recmodels_tpu_torch.utils.config import TrainConfig as TConfig
from recmodels_tpu_torch.utils.config import build_schema as tbuild_schema


def _same(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("vocab,batch,seed,task_seed,shard", [
    (1000, 64, 0, 0, (0, 1)),
    (100_000, 257, 7, 3, (1, 4)),
    ((50,) * 13 + (2000,) * 13, 1, 11, 0, (0, 1)),
])
def test_synthetic_source_byte_identical(vocab, batch, seed, task_seed, shard):
    js = jcriteo.SyntheticSource(jschema.criteo_schema(vocab_size=vocab), batch, seed=seed,
                                 shard_index=shard[0], shard_count=shard[1], task_seed=task_seed)
    ts = tcriteo.SyntheticSource(tschema.criteo_schema(vocab_size=vocab), batch, seed=seed,
                                 shard_index=shard[0], shard_count=shard[1], task_seed=task_seed)
    for jb, tb, _ in zip(js, ts, range(3)):
        for field in ("dense", "ids", "labels"):
            _same(getattr(jb, field), getattr(tb, field))
    assert js.state() == ts.state()


def test_synthetic_source_resume_matches():
    sch = tschema.criteo_schema(vocab_size=500)
    a = tcriteo.SyntheticSource(sch, 32, seed=5)
    it = iter(a)
    next(it), next(it)
    b = tcriteo.SyntheticSource(sch, 32, seed=5)
    b.set_state(a.state())
    _same(next(iter(b)).ids, next(it).ids)


def test_splitmix64_and_hashing_identical():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(0, np.iinfo(np.uint64).max, size=1000, dtype=np.uint64, endpoint=True),
        np.asarray([0, 1, np.iinfo(np.uint64).max], np.uint64),
    ])
    _same(thashing.splitmix64(x), jhashing.splitmix64(x))
    tokens = np.asarray([[b"68fd1e64", b"", b"not-hex!", b"0123456789abcdef0"]] * 2)
    vocabs = [100, 1000, 7, 2]
    _same(thashing.hash_tokens(tokens, vocabs), jhashing.hash_tokens(tokens, vocabs))


def test_transform_dense_identical():
    raw = np.asarray([[np.nan, -3.0, 0.0, 1.0, 1e6]], np.float32)
    _same(tcriteo.transform_dense(raw), jcriteo.transform_dense(raw))


@pytest.mark.parametrize("kw", [
    {},
    {"model": "xdeepfm", "bf16": True, "vocab_size": 1000, "embed_dim": 8,
     "cin_sizes": (16, 16), "hidden": (32,)},
    {"per_slot_dims": tuple([4, 8] * 13)},
])
def test_config_json_round_trips_both_ways(kw):
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    assert dataclasses.asdict(TConfig.from_json(jcfg.to_json())) == dataclasses.asdict(jcfg)
    assert JConfig.from_json(tcfg.to_json()) == jcfg
    assert dataclasses.asdict(tbuild_schema(tcfg)) == dataclasses.asdict(jbuild_schema(jcfg))


def test_model_kwargs_use_torch_dtypes():
    kw = TConfig(model="xdeepfm", bf16=True).model_kwargs()
    assert kw["compute_dtype"] is torch.bfloat16
    assert kw["cin_sizes"] == (128, 128) and kw["hidden"] == (400, 400)
    assert "compute_dtype" not in TConfig(model="xdeepfm").model_kwargs()
