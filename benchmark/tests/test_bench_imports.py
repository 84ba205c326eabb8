"""What the benchmark loads: no JAX, no jaxlib, no flax and no JAX package
in a run of any cell; nothing of the program in the reference; no result
without a card."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "recmodels_tpu")

RUN_EVERY_CELL = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
from conftest import small_run
from benchmark import harness
spec = harness.load_spec()
for w in spec["workloads"]:
    small_run(w["name"], seconds=0.2, trace=True)
print(json.dumps(sorted(sys.modules)))
"""

LOAD_REFERENCE = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import benchmark.reference.model, benchmark.reference.optim, benchmark.reference.train
import benchmark.reference.precision, benchmark.reference.criteo
for name in ("xdeepfm", "deepfm"):
    benchmark.reference.model.family({{"model": name}})
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_run_of_any_cell_loads_jax_or_the_jax_package():
    mods = loaded(RUN_EVERY_CELL)
    assert "recmodels_tpu_torch" in mods
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded(LOAD_REFERENCE)
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN + ("recmodels_tpu_torch",)]
    assert not bad, bad


def test_run_exits_without_a_result_when_there_is_no_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "xdeepfm-criteo.train-zipf",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
