"""Whether the order of the row gather's ids (#1, ``gather_rows``) moves
its time on this card: the bound on what tiles of one slot's ids could win.

    python -m recmodels_tpu_torch.probes.gather_order     # one NVIDIA GPU

It gathers the flagship batch's ids (xDeepFM, 26 slots of 1e5 ids, batch
16,384, stream seed 7, as ``chip_smoke.py`` makes them) from a 2,600,960 x
17 f32 table into bf16 rows, once in batch order (the order every path
gathers in) and once in slot-major order (each slot's 16,384 ids together,
so a tile's rows come from one slot's 1e5-row range of the table). Each is
checked bit for bit against the plain version, then timed warm by
torch.profiler over back-to-back calls and with a cold L2 (a 2 GiB write
before each call). ``chip_smoke.py`` times the gather at every instance
the paths launch. This probe prints the card's name and power limit and,
last, one JSON line of the times in ms. The port never calls it.
"""

from __future__ import annotations

import json
import subprocess

import torch

from recmodels_tpu_torch.data import SyntheticSource
from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference
from recmodels_tpu_torch.models import build_model
from recmodels_tpu_torch.probes.fanout_times import cold_ms
from recmodels_tpu_torch.probes.sparse_update_rows import warm_ms
from recmodels_tpu_torch.train.engine import Engine
from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

BATCH = 16_384


def flagship_ids(dev: torch.device) -> tuple[torch.Tensor, int]:
    """(the flagship batch's row ids in batch order, [16384, 26] int32; the table's rows)."""
    cfg = TrainConfig(model="xdeepfm", bf16=True, vocab_size=100_000, embed_dim=16, cin_sizes=(128, 128),
                      hidden=(400, 400), batch_size=BATCH, seed=0)
    schema = build_schema(cfg)
    engine = Engine(build_model(cfg.model, schema, **cfg.model_kwargs()))
    batch = next(iter(SyntheticSource(schema, batch_size=BATCH, seed=7)))
    group = engine.collections["emb"]
    return group.group_row_ids(torch.as_tensor(batch.ids, device=dev))["d17"], group.groups[0].alloc_rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gather_order: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    ids, rows = flagship_ids(dev)
    table = torch.randn((rows, 17), generator=gen, device=dev) * 0.05
    result = {}
    for name, order in (("batch order", ids), ("slot-major", ids.t().contiguous())):
        if not torch.equal(gather_rows(table, order, torch.bfloat16),
                           gather_rows_reference(table, order, torch.bfloat16)):
            raise RuntimeError(f"gather_order: {name} disagrees with the plain version")
        fn = lambda: gather_rows(table, order, torch.bfloat16)  # noqa: E731
        result[name] = {"warm": warm_ms(fn), "cold": cold_ms(fn)}
        print(f"gather d17 bf16, {name}: {result[name]['warm']:.4f} ms warm, {result[name]['cold']:.4f} cold "
              f"on {card}", flush=True)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
