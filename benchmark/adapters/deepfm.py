"""The program's DeepFM (``recmodels_tpu_torch/models/deepfm.py``): its
layouts are the reference's."""


def model_kwargs(cfg: dict) -> dict:
    return {}


def to_program(cfg: dict, name: str, w):
    return w
