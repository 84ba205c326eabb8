"""Readings that set the limits of a cell's check, on the card at the cell's
own size (the benchmark's runs never run this).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --what control,faults,program

* ``control``: the reference computed in fp8 (``reference/precision.py``)
  put in the program's place, against the f32 reference: its numbers must
  fail the check.
* ``faults`` (training cells): the reference put in the program's place
  with half of each batch left out (the mean over the rest), and with each
  step's loss altered by 5%; a state left unchanged reads 1 on
  ``change_gap`` by the gap's definition and needs no run.
  (serving cell): one logit of each answer altered by 1, and the second
  half of each answer left out (zeros).
* ``program``: sound runs of the program, each a whole run of the cell
  (``harness.run_cell``) with a window of ``--seconds``.

Prints one JSON line a seed and reading.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def training_batches(h, seed: int):
    """The first three batches of a training cell's run for ``seed``."""
    import numpy as np
    import torch

    from benchmark.gen import tsv, zipf
    from benchmark.reference import criteo

    cfg, p, dev = h.config, h.params, h.device
    b = cfg["batch_size"]
    slots = zipf.slots_for(cfg, p, seed, dev)
    if h.cell["kind"] == "train_pool":
        dense, ids, labels = zipf.batch_pool(slots, p["pool_batches"], b, cfg["n_dense"], p,
                                             zipf.generator(seed, dev, 5))
        return dense[:3].clone(), ids[:3].clone(), labels[:3].clone()
    path = os.path.join(h.tmpdir, "criteo.tsv")
    # the writer draws blocks of 2**18 rows: the first block is the file's start
    tsv.write(path, slots, min(p["rows"], 1 << 18), cfg["n_dense"], p, seed, zipf.generator(seed, dev, 9))
    arrays = criteo.parse(criteo.read_lines(path, 3 * b), cfg["n_dense"], cfg["n_slots"], cfg["vocab_size"])
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev).reshape(3, b, *x.shape[1:]) for x in arrays)


def training_readings(h, seed: int, what: str) -> list:
    """[(reading, numbers, each leaf's gradient difference)]; the f32
    reference's leaf norms go out as the reading ``reference``."""
    from benchmark import check, training

    cfg = h.config
    dense, ids, labels = training_batches(h, seed)
    ref = training.reference_readings(cfg, seed, dense, ids, labels)
    out = [("reference", {}, ref["grad"])]
    if "control" in what:
        low = training.reference_readings(cfg, seed, dense, ids, labels, precision="fp8")
        out.append(("control_fp8", check.train_numbers(low, ref), check.grad_diffs(low, ref)))
    if "faults" in what:
        half = dense.shape[1] // 2
        hb = training.reference_readings(cfg, seed, dense[:, :half], ids[:, :half], labels[:, :half])
        out.append(("fault_half_batch", check.train_numbers(hb, ref), check.grad_diffs(hb, ref)))
        altered = {**ref, "loss": [x * 1.05 for x in ref["loss"]]}
        out.append(("fault_loss_altered", check.train_numbers(altered, ref), {}))
    return out


def serving_readings(h, seed: int, what: str) -> list:
    import numpy as np

    from benchmark.traffic import serve_poisson as sp

    cfg, dev = h.config, h.device
    bodies = sp.make_bodies(cfg, h.params, seed, dev)
    every = range(len(bodies))
    out = []
    if "control" in what:
        low = sp.reference_logits(cfg, seed, bodies, every, dev, precision="fp8")
        out.append(("control_fp8", {"logit_gap": sp.reference_gap(cfg, seed, bodies, low.items(), dev)}))
    if "faults" in what:
        want = sp.reference_logits(cfg, seed, bodies, every, dev)
        altered = {i: z + (np.arange(z.size) == 0) for i, z in want.items()}
        halved = {i: np.where(np.arange(z.size) < z.size // 2, z, 0).astype(z.dtype) for i, z in want.items()}
        out.append(("fault_answer_altered", {"logit_gap": sp.reference_gap(cfg, seed, bodies, altered.items(), dev)}))
        out.append(("fault_half_batch", {"logit_gap": sp.reference_gap(cfg, seed, bodies, halved.items(), dev)}))
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
        print("control.py reads the card; no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        h = harness.Run(args.workload, seed, args.seconds, False, dev, time.perf_counter(), ROOT)
        try:
            if "program" in args.what:
                res = harness.run_cell(harness.Run(args.workload, seed, args.seconds, False, dev,
                                                   time.perf_counter(), ROOT))
                print(json.dumps({"seed": seed, "reading": "program", "checks": res["checks"],
                                  "metrics": res["metrics"]}), flush=True)
            if args.what != "program":
                kind = h.cell["kind"]
                fn = serving_readings if kind == "serve_poisson" else training_readings
                for name, numbers, *leaves in fn(h, seed, args.what):
                    print(json.dumps({"seed": seed, "reading": name, "numbers": numbers, "diffs": leaves}),
                          flush=True)
        finally:
            h.close()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
