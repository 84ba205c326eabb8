"""Readings that set the limits of the Wukong training cell's check
(``train_pool_wukong``), on the card at the cell's own size, as
``control_multihot.py`` reads DLRM-DCNv2's (the benchmark's runs never run
this).

    python3 benchmark/control_wukong.py --workload wukong-criteo1tb.train-zipf --seeds 1,2,3 --what control,faults,program

* ``control``: the reference computed in fp8 (``reference/precision.py``)
  put in the program's place, against the f32 reference: its numbers must
  fail the check.
* ``faults``: the reference put in the program's place with half of each
  batch left out, and with each step's loss altered by 5%; a state left
  unchanged reads 1 on ``change_gap`` by the gap's definition and needs no
  run.
* ``program``: sound runs of the program, each a whole run of the cell
  (``harness.run_cell``) with a window of ``--seconds``.

Prints one JSON line a seed and reading.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(h, seed: int, what: str) -> list:
    """[(reading, numbers, each leaf's gradient difference)]; the f32
    reference's leaf norms go out as the reading ``reference``."""
    from benchmark import check
    from benchmark.control_multihot import training_batches
    from benchmark.traffic import train_pool_wukong as kind

    cfg = h.config
    dense, ids, labels = training_batches(h, seed)
    ref = kind.reference_readings(cfg, seed, dense, ids, labels)
    out = [("reference", {}, ref["grad"])]
    if "control" in what:
        low = kind.reference_readings(cfg, seed, dense, ids, labels, precision="fp8")
        out.append(("control_fp8", kind.numbers(low, ref), check.grad_diffs(low, ref)))
        del low
    if "faults" in what:
        half = dense.shape[1] // 2
        hb = kind.reference_readings(cfg, seed, dense[:, :half], ids[:, :half], labels[:, :half])
        out.append(("fault_half_batch", kind.numbers(hb, ref), check.grad_diffs(hb, ref)))
        altered = {**ref, "loss": [x * 1.05 for x in ref["loss"]]}
        out.append(("fault_loss_altered", kind.numbers(altered, ref), {}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="control,faults")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control_wukong.py reads the card; no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        if "program" in args.what:
            res = harness.run_cell(harness.Run(args.workload, seed, args.seconds, False, dev, time.perf_counter(),
                                               ROOT))
            print(json.dumps({"seed": seed, "reading": "program", "checks": res["checks"],
                              "metrics": res["metrics"], "device": res["device"]}), flush=True)
            torch.cuda.empty_cache()
        if args.what != "program":
            h = harness.Run(args.workload, seed, args.seconds, False, dev, time.perf_counter(), ROOT)
            try:
                for name, numbers, *leaves in readings(h, seed, args.what):
                    print(json.dumps({"seed": seed, "reading": name, "numbers": numbers, "diffs": leaves}),
                          flush=True)
            finally:
                h.close()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
