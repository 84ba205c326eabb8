"""Export a training checkpoint as a serving artifact (``model.json`` and
``params.npz``, which both packages' ``load_predictor`` read), restored on
the CUDA card or, with ``--cpu``, on the CPU:

    python -m recmodels_tpu_torch.cli.export --ckpt-dir runs/xdeepfm --out artifacts/xdeepfm
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--cpu", action="store_true", help="restore on the CPU")
    args = ap.parse_args(argv)

    from recmodels_tpu_torch.serve import export_from_checkpoint

    export_from_checkpoint(args.ckpt_dir, args.out, device="cpu" if args.cpu else "cuda")
    print(f"exported {args.ckpt_dir} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
