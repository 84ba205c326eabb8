"""Batch scoring and evaluation on the CUDA card (``--cpu``: on the CPU),
from a training checkpoint or a serving artifact:

    python -m recmodels_tpu_torch.cli.predict --ckpt-dir runs/xdeepfm --data test.tsv --out preds.txt
    python -m recmodels_tpu_torch.cli.predict --ckpt-dir runs/xdeepfm --data test.tsv   # metrics only
    python -m recmodels_tpu_torch.cli.predict --model-dir artifacts/xdeepfm --data test.tsv

Each batch goes through the ``Predictor`` (a CUDA graph per padded bucket);
the AUC and logloss of every row read are logged at the end.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    src_arg = ap.add_mutually_exclusive_group(required=True)
    src_arg.add_argument("--ckpt-dir", help="training checkpoint dir (with config.json)")
    src_arg.add_argument("--model-dir", help="serving artifact (cli.export / serve.export_model)")
    ap.add_argument("--data", required=True, help="criteo TSV path or 'synthetic'")
    ap.add_argument("--out", default=None, help="write one probability per line")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="score on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from recmodels_tpu_torch.serve import Predictor, load_predictor
    from recmodels_tpu_torch.train import metrics as metrics_lib
    from recmodels_tpu_torch.train.engine import resolve_device
    from recmodels_tpu_torch.train.loop import Trainer, build_schema, build_source
    from recmodels_tpu_torch.utils.config import TrainConfig
    from recmodels_tpu_torch.utils.logging import MetricsLogger

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg_path = (f"{args.model_dir}/model.json" if args.model_dir
                else f"{args.ckpt_dir}/config.json")
    with open(cfg_path) as f:
        cfg = TrainConfig.from_json(f.read())
    overrides = [f"data={args.data!r}", "steps=0", "eval_every=0"]
    if args.batch_size:
        overrides.append(f"batch_size={args.batch_size}")
    if args.model_dir:
        cfg = cfg.apply_overrides(overrides)
        pred = load_predictor(args.model_dir, device=device)
        logger = MetricsLogger(None)
        logger.log_text(f"loaded serving artifact from {args.model_dir}")
    else:
        cfg = cfg.apply_overrides(overrides + [f"ckpt_dir={args.ckpt_dir!r}", "tb_dir=None"])
        trainer = Trainer(cfg, device=device)
        logger = trainer.logger
        state, _ = trainer.ckpt.restore(trainer.engine.init(seed=cfg.seed, device=device))
        logger.log_text(f"restored step {int(state.step)} from {args.ckpt_dir}")
        pred = Predictor(trainer.engine, state, device)

    # loop=False: a file source yields each row once, the ragged tail batch
    # included (padded and masked below, so every row counts)
    source = build_source(cfg, build_schema(cfg), args.data, seed=cfg.seed, loop=False)
    auc_state = metrics_lib.auc_init(device=device)
    out_f = open(args.out, "w") if args.out else None
    n = 0
    try:
        for i, b in enumerate(source):
            if args.max_batches is not None and i >= args.max_batches:
                break
            real = b.size
            labels, weight = b.labels, None
            if real != cfg.batch_size:
                # the static batch shape; padded rows get zero weight
                labels = np.concatenate([labels, np.zeros((cfg.batch_size - real,), labels.dtype)])
                weight = torch.as_tensor(np.arange(cfg.batch_size) < real, dtype=torch.float32,
                                         device=device)
            lg = np.zeros((cfg.batch_size,), np.float32)
            lg[:real] = pred.predict_logits(b.dense, b.ids)
            metrics_lib.auc_update(auc_state, torch.as_tensor(lg, device=device),
                                   torch.as_tensor(labels, device=device), weight=weight)
            n += real
            if out_f:
                for p in 1.0 / (1.0 + np.exp(-lg[:real])):
                    out_f.write(f"{p:.6f}\n")
            if args.data == "synthetic" and args.max_batches is None and i >= 19:
                break  # the synthetic stream is endless
    finally:
        if out_f:
            out_f.close()
    out = metrics_lib.auc_compute(auc_state)
    logger.log_text(f"eval n={n} auc={float(out['auc']):.6f} logloss={float(out['logloss']):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
