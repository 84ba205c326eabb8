"""Pooled embedding bags: the CUDA kernel of ``csrc/bag_gather.cu`` and its
plain PyTorch version.

A multi-hot slot (``data/schema.FeatureSpec.hotness`` > 1) holds a bag of
ids an example, and the model reads the bag's rows summed: DLRM's
sum-pooled ``EmbeddingBag``. The port's own: the JAX package has one id a
slot. The gather and the sum are one kernel on the card, so the rows of
every id are never written out (``csrc/bag_gather.cu`` says why).

Contract (both versions): ids ``[B, n_ids]`` global row ids, slot-major,
bag s of an example its ``hotness[s]`` columns after the bags before it;
each bag's f32 rows are summed in f32 in bag order, the first row starting
the sum, and the sum is cast to ``out_dtype`` once (bf16: round to nearest
even). So the two versions give the same bits, and two calls give the same
bits. Precondition: every id lies in ``[0, R)``. Neither version clamps.

Tracing (``utils/profiling.py``): the span ``emb.bag_gather``; each call
(an eager step, a capture) adds its ids to the counter ``emb.bag_lookups``
and 1 to ``emb.bag_calls``, so their ratio is the ids a step of one bag
gather.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda.launch import cuda_device, device_and_stream, require
from recmodels_tpu_torch.utils.profiling import annotate, count

OUT_DTYPES = (torch.bfloat16, torch.float32)
MAX_BAGS = 256  # bags an example the kernel takes (its offsets go by value)


def bag_gather_reference(table: torch.Tensor, ids: torch.Tensor, hotness: Sequence[int],
                         out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: gather every id's f32 row, then each bag's rows summed
    in bag order; [B, len(hotness), d] in ``out_dtype``."""
    rows = torch.index_select(table, 0, ids.reshape(-1).long()).reshape(*ids.shape, table.shape[1])
    bags, c = [], 0
    for h in hotness:
        acc = rows[:, c]
        for j in range(c + 1, c + h):
            acc = acc + rows[:, j]
        bags.append(acc)
        c += h
    return torch.stack(bags, dim=1).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _offsets(hotness: tuple) -> ctypes.Array:
    """The bags' first columns and the end, ``n_bags + 1`` C ints."""
    at = [0]
    for h in hotness:
        at.append(at[-1] + h)
    return (ctypes.c_int * len(at))(*at)


def bag_gather(table: torch.Tensor, ids: torch.Tensor, hotness: Sequence[int],
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Each bag's rows of ``table`` [R, d] f32 summed: int32 ``ids`` [B,
    sum(hotness)] -> [B, len(hotness), d] in ``out_dtype``.

    A CPU table takes the plain version; a CUDA table launches the kernel
    (or raises on what the kernel does not take)."""
    hotness = tuple(int(h) for h in hotness)
    if ids.dim() != 2 or ids.shape[1] != sum(hotness) or min(hotness, default=0) < 1:
        raise ValueError(f"bag_gather: ids {tuple(ids.shape)} do not hold bags of {hotness}")
    count("emb.bag_lookups", ids.numel())
    count("emb.bag_calls", 1)
    with annotate("emb.bag_gather"):
        if table.device.type == "cpu":
            return bag_gather_reference(table, ids, hotness, out_dtype)
        dev_t = cuda_device(table, "bag_gather")
        require("bag_gather table", table, (torch.float32,), 2, dev_t, align=4)
        require("bag_gather ids", ids, (torch.int32,), 2, dev_t, align=4)
        if out_dtype not in OUT_DTYPES:
            raise TypeError(f"bag_gather: out_dtype {out_dtype}, expected one of {OUT_DTYPES}")
        if len(hotness) > MAX_BAGS:
            raise ValueError(f"bag_gather: {len(hotness)} bags an example, the kernel takes {MAX_BAGS}")
        b, d = ids.shape[0], table.shape[1]
        out = torch.empty((b, len(hotness), d), dtype=out_dtype, device=dev_t)
        dev, stream = device_and_stream(dev_t)
        err = build.library().rm_bag_gather(
            dev, table.data_ptr(), ids.data_ptr(), out.data_ptr(), b, ids.shape[1], d, _offsets(hotness),
            len(hotness), int(out_dtype == torch.bfloat16), stream,
        )
        build.check(err, "bag_gather")
        bag_gather.launches += 1
        return out


bag_gather.launches = 0  # kernel launches since the count was last set to 0
