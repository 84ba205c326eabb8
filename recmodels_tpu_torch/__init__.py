"""recmodels_tpu_torch — the PyTorch/CUDA port of ``recmodels_tpu``.

A second package beside the JAX one, kept module for module so each
counterpart is easy to find. It imports torch, numpy and the standard library
only. The serving path (``serve.load_predictor`` -> ``Predictor`` ->
``train.engine.Engine.logits``) runs on an NVIDIA Hopper card through three
hand-written CUDA kernels (``csrc/``): the embedding row gather, the
fused-row fanout and the fused 2-layer CIN forward. Each kernel's plain
PyTorch version sits beside its wrapper and runs only for tensors on the
CPU, which is how the tests hold the port against the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
