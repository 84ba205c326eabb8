"""Find the serving cell's knee once, on the card: the highest arrival rate
whose backlog does not grow over a window.

    python3 benchmark/sweep.py --workload xdeepfm-criteo.serve-poisson --seed 7 --rates 400,800,1200 --seconds 10

One process builds the cell's Predictor and bodies once and runs the open
loop at each rate for ``--seconds``; for each it prints the requests, the
median and 99th-percentile latency, the mean service time, the worker's
busy share (service time over the loop's length) and the growth of the
backlog: the mean latency of the last quarter of requests minus that of
the first. Below the knee the growth stays near 0; above it, latency grows
through the window. The cell's ``rate_per_s`` is set to about four fifths
of the knee; this script is not part of a run.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from benchmark import harness, openloop, port
    from benchmark.gen import zipf
    from benchmark.traffic import serve_poisson as sp

    if not torch.cuda.is_available():
        print("sweep.py runs on the card; no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    h = harness.Run(args.workload, args.seed, args.seconds, False, dev, T_PROCESS, ROOT)
    cfg, prm = h.config, h.params
    bodies = sp.make_bodies(cfg, prm, h.seed, dev)
    engine = port.build_engine(cfg)
    pred = port.predictor(engine, port.serve_state(engine, cfg, h.seed, dev), dev)
    sp.warm(pred, bodies, prm["warm_calls"])
    rng = np.random.default_rng(zipf.derive_seed(h.seed, 8))
    for rate in (float(r) for r in args.rates.split(",")):
        _, lat, svc, late, length = sp.serve_program(rate, args.seconds, bodies, pred, rng)
        q = max(1, len(lat) // 4)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat), "p50_ms": statistics.median(lat) * 1e3,
            "p99_ms": openloop.percentile(lat, 99) * 1e3, "service_mean_ms": statistics.mean(svc) * 1e3,
            "busy_share": sum(svc) / length, "backlog_growth_ms": (statistics.mean(lat[-q:]) - statistics.mean(lat[:q])) * 1e3,
            "max_ms": max(lat) * 1e3, "over_10ms": sum(x > 0.01 for x in lat), "late_wakeups": late}), flush=True)
    h.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
