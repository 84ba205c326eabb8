"""Train a model on the CUDA card (``--cpu``: the plain PyTorch path on the
CPU), with checkpoints, resume, eval and logging:

    python -m recmodels_tpu_torch.cli.train --model xdeepfm --steps 2000 --set batch_size=4096
    python -m recmodels_tpu_torch.cli.train --model lr --data /path/to/criteo.tsv
    python -m recmodels_tpu_torch.cli.train --model xdeepfm --data device_synth --set batch_size=16384
        # batches generated on the card inside the captured step: no host producer
    python -m recmodels_tpu_torch.cli.train --config runs/xdeepfm/config.json   # reproduce a run
    torchrun --nproc_per_node 4 -m recmodels_tpu_torch.cli.train --model xdeepfm --devices 4
        # one process a card, the tables row-sharded over the four (NCCL)
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default=None,
                    choices=["lr", "fm", "deepfm", "pnn", "dcn", "xdeepfm", "widedeep", "nfm", "afm"])
    ap.add_argument("--data", default=None,
                    help="'synthetic' (host-generated), 'device_synth' (generated on the device) or a Criteo "
                         "TSV path")
    ap.add_argument("--val-data", default=None, help="the held-out stream, as --data (default: --data's)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--devices", type=int, default=None,
                    help="1 = local tables; N > 1 = tables row-sharded over a process group of N ranks, one "
                         "device each (launch with torchrun); default: the group's size, 1 without one")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--tb-dir", default=None)
    ap.add_argument("--config", default=None, help="load a config.json")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, repeatable")
    ap.add_argument("--cpu", action="store_true", help="run the plain PyTorch path on the CPU")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of superbatches 2-4 into this dir")
    args = ap.parse_args(argv)

    from recmodels_tpu_torch.parallel import multihost
    from recmodels_tpu_torch.train.loop import Trainer
    from recmodels_tpu_torch.utils.config import TrainConfig

    if args.config:
        with open(args.config) as f:
            cfg = TrainConfig.from_json(f.read())
    else:
        cfg = TrainConfig()
    direct = {
        "model": args.model,
        "data": args.data,
        "val_data": args.val_data,
        "steps": args.steps,
        "batch_size": args.batch_size,
        "n_devices": args.devices,
        "ckpt_dir": args.ckpt_dir,
        "tb_dir": args.tb_dir,
    }
    overrides = [f"{k}={v!r}" for k, v in direct.items() if v is not None]
    cfg = cfg.apply_overrides(overrides + args.set)

    device = "cpu" if args.cpu else "cuda"
    multihost.initialize(device=device)  # a launcher's process group (torchrun), if any
    trainer = Trainer(cfg, device=device)
    trainer.logger.log_text(
        f"model={cfg.model} device={trainer.device} batch={cfg.batch_size} "
        f"steps={cfg.steps} data={cfg.data}"
    )
    if args.profile_dir:
        trainer.profile_dir = args.profile_dir
    final = trainer.run()
    trainer.logger.log_text(f"done: {final}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
