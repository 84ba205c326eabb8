"""How fast the sparse table updates could be on this card: the touched
rows' own cost, without an optimizer's arithmetic or the grads.

    python -m recmodels_tpu_torch.probes.sparse_update_rows     # one NVIDIA GPU

It builds ``sparse_update_rows.cu`` with nvcc (into ``recmodels_tpu_torch/
_build/probes/``), makes the flagship batch's sorted id stream as
``chip_smoke.py`` does (xDeepFM, 26 slots of 1e5 ids, batch 16,384, stream
seed 7) and times, warm by torch.profiler over back-to-back calls, the
access patterns of ``rm_probe_rows`` over its unique rows: two [R, 17]
arrays (Adagrad's table and acc on the fused table), three [R, 16] (lazy
Adam's table, m and v), and the dim-1 tables. It prints the card's name and
power limit and, last, one JSON line of the times in ms. The port never
calls it; ``PERF.md`` reads its numbers as the floor of the update kernels.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from recmodels_tpu_torch.data import SyntheticSource
from recmodels_tpu_torch.embedding.optim import slot_sorted_ids
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.ops.cuda import build
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

SOURCE = build.PACKAGE / "probes" / "sparse_update_rows.cu"
PATTERNS = {  # rm_probe_rows' patterns
    "rmw, a thread an element": 0,
    "rmw, a thread four columns (float4)": 1,
    "read only, a thread an element": 2,
    "write only, a thread an element": 3,
    "rmw, a warp's 32 rows in rounds": 4,
    "rmw, a warp holding 17 elements a lane": 5,
    "rmw, a warp holding 8 elements a lane": 6,
    "rmw, a warp staging by 4-byte cp.async": 7,
}


def library() -> ctypes.CDLL:
    out = build.BUILD / "probes" / "libprobe_rows.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(out), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.rm_probe_rows.argtypes = [ctypes.c_int, p, p, p, p, ctypes.c_longlong, ctypes.c_int, p, p]
    lib.rm_probe_rows.restype = ctypes.c_int
    return lib


def warm_ms(fn, calls: int = 20) -> float:
    """Device time per call of the kernels ``fn`` launches, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            total += e.self_cuda_time_total if us is None else us
    if total == 0:
        raise RuntimeError("the profiler recorded no kernel of the card")
    return total / 1e3 / calls


def flagship_rows(dev: torch.device) -> tuple[torch.Tensor, int]:
    """(the flagship stream's unique row ids, int32 ascending; the table's rows)."""
    cfg = TrainConfig(model="xdeepfm", bf16=True, vocab_size=100_000, embed_dim=16, cin_sizes=(128, 128),
                      hidden=(400, 400), batch_size=16_384, seed=0)
    schema = build_schema(cfg)
    engine = Engine(build_model(cfg.model, schema, **cfg.model_kwargs()))
    batch = next(iter(SyntheticSource(schema, batch_size=16_384, seed=7)))
    group = engine.collections["emb"]
    sorted_ids, _, _ = slot_sorted_ids(group.group_row_ids(torch.as_tensor(batch.ids, device=dev))["d17"])
    return torch.unique(sorted_ids).to(torch.int32), group.groups[0].alloc_rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sparse_update_rows: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = library()
    rows, table_rows = flagship_rows(dev)
    shuffled = rows[torch.randperm(rows.numel(), device=dev, generator=torch.Generator(dev).manual_seed(0))]
    sink = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"unique_rows": rows.numel(), "table_rows": table_rows, "ms": {}}
    for d, arrays in ((17, 2), (16, 3), (1, 2), (1, 3)):
        shape = (table_rows, d) if d > 1 else (table_rows,)
        state = [torch.randn(shape, device=dev) for _ in range(arrays)]
        ptrs = [t.data_ptr() for t in state] + [None] * (3 - arrays)
        for name, pattern in PATTERNS.items():
            if (pattern == 1 and d % 4) or (pattern >= 4 and (arrays != 2 or d == 1)):
                continue
            for order, ids in (("sorted", rows), ("shuffled", shuffled)):
                if order == "shuffled" and pattern != 0:
                    continue
                def fn(pattern=pattern, ids=ids):
                    err = lib.rm_probe_rows(pattern, *ptrs, ids.data_ptr(), ids.numel(), d, sink.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"rm_probe_rows: CUDA error {err}")
                key = f"d{d} x{arrays}: {name}, {order} rows"
                result["ms"][key] = warm_ms(fn)
                print(f"{key}: {result['ms'][key]:.4f} ms warm on {card}", flush=True)
        del state
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
