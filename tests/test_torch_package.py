"""The port's package surface against the JAX package's: the top-level
names (resolved lazily, so the torch-free data layer stays torch-free), the
``embedding`` and ``ops`` exports, ``EmbeddingCollection``'s lookup methods
(``tests/test_embedding.py``'s three lookup cases, each against JAX's
lookup of the same tables) and ``cin_sum_pool``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recmodels_tpu
import recmodels_tpu.embedding
import recmodels_tpu.ops
import recmodels_tpu_torch
import recmodels_tpu_torch.embedding
import recmodels_tpu_torch.ops
from recmodels_tpu.data.schema import criteo_schema as jcriteo_schema
from recmodels_tpu.embedding import EmbeddingCollection as JCollection
from recmodels_tpu.ops.interactions import cin_sum_pool as jcin_sum_pool
from recmodels_tpu_torch.data.schema import criteo_schema
from recmodels_tpu_torch.embedding import EmbeddingCollection
from recmodels_tpu_torch.ops.interactions import cin_sum_pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vocab():
    return [50 + 10 * i for i in range(26)]


def _both(vocab, dims, seed):
    """The JAX collection, its tables, and the port's collection holding the
    same tables."""
    jc = JCollection(jcriteo_schema(vocab_size=vocab, embed_dim=dims))
    jparams = jc.init(jax.random.key(seed))
    pc = EmbeddingCollection(criteo_schema(vocab_size=vocab, embed_dim=dims))
    params = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jparams.items()}
    return jc, jparams, pc, params


def test_lookup_shapes_uniform():
    jc, jparams, pc, params = _both(_vocab(), 8, 0)
    assert len(pc.groups) == 1
    ids = np.zeros((4, 26), np.int32)
    out = pc.lookup(params, torch.from_numpy(ids))
    assert out.shape == (4, 26, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jc.lookup(jparams, jnp.asarray(ids))))


def test_lookup_per_slot_dims_padding():
    jc, jparams, pc, params = _both(100, [4] * 10 + [8] * 10 + [16] * 6, 0)
    assert len(pc.groups) == 3
    ids = np.random.default_rng(0).integers(0, 100, size=(3, 26)).astype(np.int32)
    out = pc.lookup(params, torch.from_numpy(ids)).numpy()
    assert out.shape == (3, 26, 16)
    # slots with dim 4 (8) are zero beyond lane 4 (8)
    assert np.abs(out[:, 0, 4:]).max() == 0 and np.abs(out[:, 10, 8:]).max() == 0
    assert np.abs(out[:, 25, :]).max() > 0
    np.testing.assert_array_equal(out, np.asarray(jc.lookup(jparams, jnp.asarray(ids))))


def test_lookup_matches_per_slot_manual():
    jc, jparams, pc, params = _both(_vocab(), 8, 1)
    ids = np.random.default_rng(1).integers(0, 50, size=(5, 26)).astype(np.int32)
    out = pc.lookup(params, torch.from_numpy(ids)).numpy()
    table = params["d8"].numpy()
    g = pc.groups[0]
    for s_pos, slot in enumerate(g.slot_indices):
        np.testing.assert_array_equal(out[:, slot, :], table[ids[:, slot] + g.row_offsets[s_pos]])
    np.testing.assert_array_equal(out, np.asarray(jc.lookup(jparams, jnp.asarray(ids))))


@pytest.mark.parametrize("dims", [8, [1] * 13 + [16] * 13])
def test_param_shapes_gather_rows_and_nbytes_equal_jax(dims):
    """``param_shapes``, ``nbytes`` and ``gather_rows`` (dim-1 groups as one
    column; in bf16 as JAX's cast) as the JAX collection's."""
    jc, jparams, pc, params = _both(_vocab(), dims, 2)
    assert pc.param_shapes() == jc.param_shapes()
    assert pc.nbytes() == jc.nbytes()
    ids = np.random.default_rng(2).integers(0, 50, size=(7, 26)).astype(np.int32)
    jg = jc.group_row_ids(jnp.asarray(ids))
    pg = pc.group_row_ids(torch.from_numpy(ids))
    for dtype, jdtype in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        got, want = pc.gather_rows(params, pg, dtype), jc.gather_rows(jparams, jg, jdtype)
        for name in want:
            assert got[name].shape == want[name].shape
            np.testing.assert_array_equal(got[name].float().numpy(), np.asarray(want[name]).astype(np.float32))


def test_cin_sum_pool_equals_jax():
    x = np.random.default_rng(3).normal(size=(4, 6, 16)).astype(np.float32)
    np.testing.assert_allclose(cin_sum_pool(torch.from_numpy(x)).numpy(), np.asarray(jcin_sum_pool(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_exports_name_the_jax_packages():
    assert set(recmodels_tpu_torch.__all__) == set(recmodels_tpu.__all__)
    assert set(recmodels_tpu.embedding.__all__) <= set(recmodels_tpu_torch.embedding.__all__)
    assert set(recmodels_tpu_torch.ops.__all__) == set(recmodels_tpu.ops.__all__)
    for module in (recmodels_tpu_torch, recmodels_tpu_torch.embedding, recmodels_tpu_torch.ops):
        for name in module.__all__:
            assert getattr(module, name) is not None
    with pytest.raises(AttributeError):
        recmodels_tpu_torch.not_a_name  # noqa: B018


def test_top_level_names_resolve_without_loading_torch():
    """In a fresh interpreter: importing the package and its data layer
    loads no torch (the spawned producer workers depend on it); the
    data-layer names resolve without it, and the rest load it on first use."""
    script = (
        "import sys\n"
        "import recmodels_tpu_torch, recmodels_tpu_torch.data\n"
        "assert 'torch' not in sys.modules\n"
        "from recmodels_tpu_torch import criteo_schema, SyntheticSource, CriteoTSVSource\n"
        "assert criteo_schema().n_slots == 26 and 'torch' not in sys.modules\n"
        "from recmodels_tpu_torch import build_model, MODEL_REGISTRY, Engine, TrainState, TrainConfig\n"
        "assert 'torch' in sys.modules and 'xdeepfm' in MODEL_REGISTRY\n"
        "assert Engine.__module__ == 'recmodels_tpu_torch.train.engine'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
