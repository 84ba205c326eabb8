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

The JAX package's top-level names (``criteo_schema``, ``CriteoTSVSource``,
``SyntheticSource``, ``build_model``, ``MODEL_REGISTRY``, ``Engine``,
``TrainState``, ``TrainConfig``) resolve here at first use, so importing the
package, or its torch-free ``data`` layer (the spawned producer workers),
loads no torch.
"""

import importlib

__version__ = "0.1.0"

_LAZY = {
    "criteo_schema": "recmodels_tpu_torch.data",
    "CriteoTSVSource": "recmodels_tpu_torch.data",
    "SyntheticSource": "recmodels_tpu_torch.data",
    "build_model": "recmodels_tpu_torch.models",
    "MODEL_REGISTRY": "recmodels_tpu_torch.models",
    "Engine": "recmodels_tpu_torch.train.engine",
    "TrainState": "recmodels_tpu_torch.train.engine",
    "TrainConfig": "recmodels_tpu_torch.utils.config",
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name]), name)
    globals()[name] = value
    return value
