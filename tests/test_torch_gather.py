"""The port's row gather (plain version, the one the CPU runs) against the
JAX package: ``jnp.take`` and the Pallas sweep gather in interpret mode.
bf16 rows must be the exact cast and f32 rows bit-exact, for ids sorted (the
Pallas kernel's input) and in batch order (the port's serving path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.embedding import pallas_gather
from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16, np.uint16), "f32": (torch.float32, jnp.float32, np.uint32)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_gather, "_INTERPRET", True)


def _bits(x, dtype) -> np.ndarray:
    """Raw bits of a torch or JAX array."""
    torch_dt, _, bits = DTYPES[dtype]
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch_dt
        x = x.view(torch.int16 if bits is np.uint16 else torch.int32).numpy()
    return np.asarray(x).view(bits)


def _case(order: str, seed: int = 0, rows: int = 4096, dim: int = 17):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    ids = np.concatenate([
        rng.integers(0, rows, size=600),
        np.zeros(50, np.int64),  # heavy duplicates
        rng.integers(0, pallas_gather.TR, size=40),  # many ids in one tile
        [rows - 1],
    ]).astype(np.int32)
    ids = np.sort(ids) if order == "sorted" else rng.permutation(ids)
    return table, ids


@pytest.mark.parametrize("order", ["sorted", "batch"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_gather_reference_matches_take_and_pallas(order, dtype):
    torch_dt, jax_dt, _ = DTYPES[dtype]
    table, ids = _case(order)
    got = gather_rows_reference(torch.from_numpy(table), torch.from_numpy(ids), torch_dt)
    take = jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0).astype(jax_dt)
    np.testing.assert_array_equal(_bits(got, dtype), _bits(take, dtype))
    # the Pallas sweep takes sorted ids; un-permute its rows for batch order
    order_ix = np.argsort(ids, kind="stable")
    swept = pallas_gather.sorted_gather(
        pallas_gather.pack(jnp.asarray(table)), jnp.asarray(ids[order_ix]), out_dtype=jax_dt
    )[:, : table.shape[1]]
    unsorted = np.empty_like(np.asarray(swept))
    unsorted[order_ix] = np.asarray(swept)
    np.testing.assert_array_equal(_bits(got, dtype), _bits(unsorted, dtype))


@pytest.mark.parametrize("shape", [(1,), (7, 3), (16, 26)])
def test_gather_rows_on_cpu_is_the_plain_version(shape):
    table, ids = _case("batch", seed=1)
    ids_t = torch.from_numpy(ids[: int(np.prod(shape))].reshape(shape))
    before = gather_rows.launches
    got = gather_rows(torch.from_numpy(table), ids_t, torch.bfloat16)
    assert got.shape == (*shape, table.shape[1])
    assert torch.equal(got, gather_rows_reference(torch.from_numpy(table), ids_t, torch.bfloat16))
    assert gather_rows.launches == before  # no kernel launched for a CPU tensor


def test_gather_out_of_range_id_is_not_clamped():
    table = torch.zeros((8, 3))
    with pytest.raises(IndexError):
        gather_rows(table, torch.tensor([[0, 8]], dtype=torch.int32), torch.float32)


def test_gather_rows_rejects_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        gather_rows(torch.zeros((8, 3), device="meta"), torch.zeros((2,), dtype=torch.int32, device="meta"))
