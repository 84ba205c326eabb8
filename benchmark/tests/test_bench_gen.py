"""The benchmark's generator: Zipf ids that repeat by seed and follow
their law, TSV text that both parsers read alike, weights made again."""

import math

import numpy as np
import pytest
import torch

from benchmark.gen import tsv, weights, zipf
from benchmark.reference import criteo

PARAMS = {"zipf_exponent": 1.05, "dense_log_mean": 1.0, "dense_log_std": 1.5, "dense_max": 9999999,
          "dense_missing": 0.1, "label_rate": 0.25, "cat_missing": 0.05}
BIG_SEED = 2**31 + 12345678901


def draw(seed, n=4096, vocab=1000, slots=26):
    s = zipf.ZipfSlots([vocab] * slots, vocab, PARAMS["zipf_exponent"], seed, "cpu")
    return zipf.examples(s, n, 13, PARAMS, zipf.generator(seed, "cpu", 5))


def test_same_seed_same_examples_and_another_seed_others():
    a, b, c = draw(BIG_SEED), draw(BIG_SEED), draw(BIG_SEED + 1)
    for x, y in zip(a, b):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())
    assert not torch.equal(a[1], c[1])


def test_derive_seed_takes_any_whole_number():
    for seed in (0, 1, 2**31 - 1, 2**31, BIG_SEED, 2**64 + 3, -5):
        d = zipf.derive_seed(seed, 3)
        assert 0 <= d < 2**63
    assert zipf.derive_seed(5, 1) != zipf.derive_seed(5, 2)


def test_ranks_follow_the_zipf_law():
    vocab, s, n = 1000, 1.05, 200_000
    slots = zipf.ZipfSlots([vocab], vocab, s, 11, "cpu")
    ranks = slots.ranks(n, zipf.generator(11, "cpu", 5))[:, 0].numpy()
    counts = np.bincount(ranks, minlength=vocab)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -s
    p /= p.sum()
    for k in range(10):  # the head, each within 5 sigma
        assert abs(counts[k] - n * p[k]) < 5 * math.sqrt(n * p[k] * (1 - p[k])), k
    # the slope of log frequency against log rank over ranks 1-50
    k = np.arange(1, 51)
    slope = np.polyfit(np.log(k), np.log(counts[:50]), 1)[0]
    assert abs(slope + s) < 0.1
    # a slot's ids are its ranks through a permutation: same histogram, other rows
    ids = slots.ids_of(torch.from_numpy(ranks)[:, None])[:, 0].numpy()
    assert sorted(np.bincount(ids, minlength=vocab)) == sorted(counts)
    assert np.argmax(np.bincount(ids, minlength=vocab)) == slots.perms[0][0]


def test_each_slot_draws_from_its_own_cardinality_over_the_whole_table():
    cfg = {"vocab_size": 10_000, "n_slots": 3}
    params = {**PARAMS, "id_cardinalities": [3, 500, 10_000_000]}
    slots = zipf.slots_for(cfg, params, BIG_SEED, "cpu")
    assert slots.vocab_sizes == [3, 500, 10_000]
    ids = slots.ids_of(slots.ranks(50_000, zipf.generator(BIG_SEED, "cpu", 5)))
    distinct = [torch.unique(ids[:, s]).numel() for s in range(3)]
    assert distinct[0] == 3 and 450 < distinct[1] <= 500 and distinct[2] > 3000
    assert int(ids.min()) >= 0 and int(ids.max()) < 10_000
    assert int(ids[:, 1].max()) > 5000  # a small slot's values are scattered over its rows
    uniform = zipf.slots_for(cfg, {**params, "zipf_exponent": 0.0}, 1, "cpu")
    counts = torch.bincount(uniform.ranks(60_000, zipf.generator(1, "cpu", 5))[:, 0], minlength=3)
    assert (counts - 20_000).abs().max() < 5 * math.sqrt(60_000 * (1 / 3) * (2 / 3))
    with pytest.raises(ValueError):
        zipf.slots_for(cfg, {**params, "id_cardinalities": [3, 500]}, 1, "cpu")


def test_dense_features_and_labels():
    dense, ids, labels = draw(3, n=20_000)
    assert dense.shape == (20_000, 13) and ids.dtype == torch.int32
    assert torch.isfinite(dense).all() and (dense >= 0).all()
    assert 0.05 < float((dense == 0).float().mean()) < 0.5  # missing values and zero counts
    assert abs(float(labels.mean()) - 0.25) < 0.02
    assert int(ids.min()) >= 0 and int(ids.max()) < 1000


def test_tsv_text_reads_alike_in_the_reference_and_the_program(tmp_path):
    from recmodels_tpu_torch.data.criteo import parse_criteo_lines
    from recmodels_tpu_torch.data.schema import criteo_schema

    vocab = 5000
    slots = zipf.ZipfSlots([vocab] * 26, vocab, 1.05, 9, "cpu")
    path = str(tmp_path / "x.tsv")
    nbytes = tsv.write(path, slots, 3000, 13, PARAMS, 9, zipf.generator(9, "cpu", 9), block=1024)
    lines = criteo.read_lines(path, 3000)
    assert len(lines) == 3000 and sum(len(x) for x in lines) == nbytes
    fields = [x.rstrip(b"\n").split(b"\t") for x in lines]
    assert all(len(f) == 40 for f in fields)
    assert any(f[14] == b"" for f in fields) and any(f[1] == b"" for f in fields)
    d_ref, i_ref, l_ref = criteo.parse(lines, 13, 26, vocab)
    prog = parse_criteo_lines(lines, criteo_schema(vocab_size=vocab, embed_dim=16))
    np.testing.assert_array_equal(i_ref, prog.ids)
    np.testing.assert_array_equal(l_ref, prog.labels)
    np.testing.assert_allclose(d_ref, prog.dense, rtol=1e-6)


def test_tokens_are_a_bijection_of_ranks():
    ranks = torch.arange(100_000, dtype=torch.int64)[:, None].expand(100_000, 3)
    tok = tsv.tokens_of(ranks, 77)
    for s in range(3):
        assert torch.unique(tok[:, s]).numel() == 100_000
    assert int(tok.max()) < 2**32


@pytest.mark.parametrize("model", ["xdeepfm", "deepfm"])
def test_weights_are_made_again_from_the_seed(model):
    cfg = {"model": model, "n_slots": 4, "vocab_size": 50, "embed_dim": 16, "n_dense": 13, "init_scale": 0.05,
           "cin_sizes": [8, 8], "hidden": [16, 16]}
    table = torch.full((256, 17), 7.0)
    weights.fill_table(table, cfg, BIG_SEED)
    assert torch.equal(table[200:], torch.zeros(56, 17))
    gids = torch.tensor([0, 3, 49, 50, 120, 199])
    assert torch.equal(weights.initial_rows(cfg, BIG_SEED, gids), table[gids])
    a, b = weights.dense_weights(cfg, BIG_SEED, "cpu"), weights.dense_weights(cfg, BIG_SEED, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(float(v.abs().sum()) > 0 for v in a.values())  # every parameter live
