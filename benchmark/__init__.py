"""The benchmark of recmodels_tpu_torch on one H100: see BENCHMARK.json and
run.py. Imports neither JAX nor the JAX package."""
