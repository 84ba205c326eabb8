"""Embedding row gather: the CUDA kernel of ``csrc/gather.cu`` and its plain
PyTorch version.

Counterpart of ``recmodels_tpu/embedding/pallas_gather.py``. The TPU kernel
needs a packed table and sorted ids; this one reads a plain row-major
``[R, D+1]`` f32 table at ids in any order, so the serving path gathers in
batch order with no sort and no un-permute (``csrc/gather.cu`` says why).

Contract (both versions): bf16 output is the round-to-nearest-even cast of
each f32 value, bit for bit JAX's ``astype``; f32 output is a bit-exact copy.
Precondition: every id lies in ``[0, R)``. Neither version clamps.
"""

from __future__ import annotations

import torch

from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.ops.cuda.launch import cuda_device, device_and_stream, require

OUT_DTYPES = (torch.bfloat16, torch.float32)


def gather_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: ``table[ids]`` cast to ``out_dtype``; [*ids.shape, D+1]."""
    rows = torch.index_select(table, 0, ids.reshape(-1))
    return rows.to(out_dtype).reshape(*ids.shape, table.shape[1])


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Rows of ``table`` [R, D+1] f32 at int32 ``ids`` (any shape, any
    order, duplicates fine) -> [*ids.shape, D+1] in ``out_dtype``.

    A CPU table takes the plain version; a CUDA table launches the kernel
    (or raises on what the kernel does not take)."""
    if table.device.type == "cpu":
        return gather_rows_reference(table, ids, out_dtype)
    dev_t = cuda_device(table, "gather_rows")
    require("gather_rows table", table, (torch.float32,), 2, dev_t)
    require("gather_rows ids", ids, (torch.int32,), ids.dim(), dev_t, align=4)
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"gather_rows: out_dtype {out_dtype}, expected one of {OUT_DTYPES}")
    d1 = table.shape[1]
    out = torch.empty((*ids.shape, d1), dtype=out_dtype, device=dev_t)
    dev, stream = device_and_stream(dev_t)
    err = build.library().rm_gather_rows(
        dev, table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(), d1,
        int(out_dtype == torch.bfloat16), stream,
    )
    build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0  # kernel launches since the count was last set to 0
