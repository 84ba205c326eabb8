"""recmodels_tpu_torch — the PyTorch/CUDA port of ``recmodels_tpu``.

A second package beside the JAX one, kept module for module so each
counterpart is easy to find. It imports torch, numpy and the standard library
only. It serves, trains and evaluates the nine models of the JAX zoo (LR,
FM, DeepFM, PNN, DCN, xDeepFM, Wide&Deep, NFM, AFM) on one NVIDIA Hopper
card. Users start at the command line: ``python -m
recmodels_tpu_torch.cli.train`` (``train/loop.Trainer``: the data feed,
schedules, eval, logging, checkpoints and resume), ``.cli.export`` and
``.cli.predict``. Beneath them: ``serve.load_predictor`` -> ``Predictor`` (a CUDA graph a request
bucket) -> ``train.engine.Engine.logits``; ``Engine.train_step`` (dense
Adam, Adagrad or SGD; sparse Adagrad, lazy Adam or dense Adam on the
tables) and ``jit_train_step`` (a CUDA graph a batch shape);
``train_step_accum`` and its graph; ``Engine.eval_step`` and
``jit_eval_step`` into a streaming AUC/logloss state
(``train/metrics.py``). Each TPU kernel of the JAX package is a
hand-written CUDA kernel (``csrc/``: the row gather, the fused-row fanout
and its backward, the fused 2-layer CIN and its backward, the CIN layer and
its backward, the field transpose, the sparse Adagrad and lazy Adam updates,
the FM term and the DCN cross stack); each kernel's plain PyTorch version
sits beside its wrapper and runs only for tensors on the CPU, which is how
the tests hold the port against the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the CLIs: ``--cpu``).
"""
