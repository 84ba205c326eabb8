"""The port's command-line entry points: ``python -m recmodels_tpu_torch.cli.train``,
``.cli.export`` and ``.cli.predict`` (the JAX package's ``train.py``,
``export.py`` and ``predict.py``, with the same flags)."""
