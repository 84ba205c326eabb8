"""The port's data layer and config against the JAX package's: the same seeds
and inputs give byte-identical arrays, and config JSON round-trips both ways."""

import dataclasses
import os

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


# ------------------------------------------------ slice 7: Criteo TSV input
FIXTURE = str(__import__("pathlib").Path(__file__).parent / "fixtures" / "criteo_sample.tsv")


def _schemas(vocab=100_000):
    return jschema.criteo_schema(vocab_size=vocab), tschema.criteo_schema(vocab_size=vocab)


def _fixture_lines():
    with open(FIXTURE, "rb") as f:
        return f.readlines()


def _same_batch(a, b) -> None:
    for field in ("dense", "ids", "labels"):
        _same(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("vocab", [100_000, [1000 + 37 * i for i in range(26)]])
def test_criteo_parsers_bit_for_bit_with_jax(vocab):
    """The Python parser against JAX's Python parser, and the native parser
    (built with g++ from the port's copy of the source) against JAX's
    native parser, on the fixture's 96 lines and on lines without their
    newline: equal bytes."""
    from recmodels_tpu.data import fastparse as jfastparse

    js, ts = _schemas(vocab)
    lines = _fixture_lines()
    _same_batch(tcriteo.parse_criteo_lines(lines, ts), jcriteo.parse_criteo_lines(lines, js))
    assert jfastparse.available()
    native = tcriteo.parse_criteo_batch(lines, ts)
    _same_batch(native, jcriteo.parse_criteo_batch(lines, js, use_native=True))
    _same_batch(tcriteo.parse_criteo_batch([l.rstrip(b"\n") for l in lines[:7]], ts),
                jcriteo.parse_criteo_batch(lines[:7], js, use_native=True))
    python = tcriteo.parse_criteo_batch(lines, ts, use_native=False)
    _same(native.ids, python.ids)
    _same(native.labels, python.labels)
    np.testing.assert_allclose(native.dense, python.dense, rtol=1e-6, atol=1e-7)


def test_native_parser_build_failure_raises(monkeypatch, tmp_path):
    """A parser that does not build raises; nothing takes the Python parser
    in its place."""
    from recmodels_tpu_torch.data import fastparse

    bad = tmp_path / "_fastparse.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastparse, "SRC", bad)
    monkeypatch.setattr(fastparse, "BUILD", tmp_path / "_build")
    fastparse.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tcriteo.parse_criteo_batch(_fixture_lines()[:3], tschema.criteo_schema(vocab_size=1000))
    finally:
        fastparse.library.cache_clear()


@pytest.mark.parametrize("shard,shuffle,loop", [((0, 1), 0, False), ((1, 3), 0, True), ((0, 2), 16, True),
                                                 ((2, 3), 7, False)])
def test_criteo_source_bit_for_bit_with_jax(shard, shuffle, loop):
    """CriteoTSVSource's shards, windowed shuffle, looping, ragged tail and
    cursor: the same batches as JAX's for every batch of two epochs, and a
    source resumed from a cursor mid-stream continues with the same ones."""
    js, ts = _schemas()
    kw = dict(shard_index=shard[0], shard_count=shard[1], loop=loop, shuffle_buffer=shuffle, seed=3)
    j = jcriteo.CriteoTSVSource(FIXTURE, js, 10, **kw)
    t = tcriteo.CriteoTSVSource(FIXTURE, ts, 10, **kw)
    n = 0
    for jb, tb, _ in zip(j, t, range(12)):
        _same_batch(tb, jb)
        assert t.state() == j.state()
        n += 1
        if n == 4:
            cursor = t.state()
    assert n == (12 if loop else -(-len(range(shard[0], 96, shard[1])) // 10))
    resumed = tcriteo.CriteoTSVSource(FIXTURE, ts, 10, **kw)
    resumed.set_state(cursor)
    again = tcriteo.CriteoTSVSource(FIXTURE, ts, 10, **kw)
    for tb, want, _ in zip(resumed, list(zip(range(n), again))[4:], range(3)):
        _same_batch(tb, want[1])


def test_make_batch_iterator_drops_the_ragged_tail():
    js, ts = _schemas()
    full = [b.size for b in tcriteo.make_batch_iterator(tcriteo.CriteoTSVSource(FIXTURE, ts, 40))]
    every = [b.size for b in tcriteo.make_batch_iterator(tcriteo.CriteoTSVSource(FIXTURE, ts, 40), False)]
    assert full == [40, 40] and every == [40, 40, 16]
    assert every == [b.size for b in jcriteo.make_batch_iterator(jcriteo.CriteoTSVSource(FIXTURE, js, 40),
                                                                   False)]


def test_pool_batches_equal_the_sources_and_its_children_hold_no_torch():
    """The spawned generation pool gives ``source._make(step)``'s batches of
    its steps in order; its children import no torch and see no CUDA
    device, and the parent's environment is as it was."""
    from recmodels_tpu_torch.data import genpool

    ts = tschema.criteo_schema(vocab_size=1000)
    src = tcriteo.SyntheticSource(ts, 64, seed=4)
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    pool = genpool.make_pool(src, 2, range(5, 14))
    try:
        assert os.environ.get("CUDA_VISIBLE_DEVICES") == before
        for step, (d, i, l) in zip(range(5, 14), pool):
            _same_batch(tcriteo.Batch(dense=d, ids=i, labels=l), src._make(step))
        assert next(pool, None) is None
        probe = "(sorted(m for m in __import__('sys').modules if m.split('.')[0] == 'torch'), " \
                "__import__('os').environ.get('CUDA_VISIBLE_DEVICES'))"
        for torch_modules, visible in pool.executor.map(eval, [probe] * 4):
            assert torch_modules == [] and visible == ""
    finally:
        pool.close()
    assert genpool.make_pool(src, 1, range(3)) is None
    assert genpool.make_pool(tcriteo.CriteoTSVSource(FIXTURE, ts, 8), 4, range(3)) is None


def test_pool_close_mid_stream_returns():
    """Closed with batches still being made (a run that stops early), the
    pool cancels what has not started, waits for the rest and returns."""
    import threading

    from recmodels_tpu_torch.data import genpool

    src = tcriteo.SyntheticSource(tschema.criteo_schema(vocab_size=100_000), 16384, seed=6)
    pool = genpool.make_pool(src, 2, range(1000))
    next(pool)
    closer = threading.Thread(target=pool.close)
    closer.start()
    closer.join(timeout=120)
    assert not closer.is_alive()


def test_config_overrides_match_jax():
    """``apply_overrides`` (literal values, bare strings, tuples) gives the
    JAX package's config; an unknown key raises ``KeyError`` in both."""
    ovs = ["batch_size=64", "hidden=(8, 8)", "data=x.tsv", "lr_schedule='cosine'", "val_data=None",
           "dense_weight_decay=1e-4"]
    got, want = TConfig().apply_overrides(ovs), JConfig().apply_overrides(ovs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hidden == (8, 8) and got.data == "x.tsv" and got.val_data is None
    with pytest.raises(KeyError, match="unknown config key: nope"):
        TConfig().apply_overrides(["nope=1"])
