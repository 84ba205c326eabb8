"""Run one cell of the benchmark once, on the CUDA card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads, warms up every shape the cell uses
(set-up, timed as ``setup_s`` from the start of this process), measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on stdout: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; ``checks`` last, each number compared beside its limit, as
on the last lines of stderr.

Exits 2, printing no result, without a CUDA card (or with fewer than the
cell asks for); exits 3 if JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"  # fixed: only a checkout's first run builds


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    entry = {w["name"]: w for w in harness.load_spec(ROOT)["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace), device, T_PROCESS, ROOT)
    result = harness.run_cell(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded modules it must not: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
