"""Model registry (port of ``recmodels_tpu/models/__init__.py``).

xDeepFM, FM, DeepFM and DCN are ported; the other five models of the JAX
zoo are registered by name and raise until ROADMAP.md's queue 1, item 3
ports them."""

from recmodels_tpu_torch.models.base import CTRModel, wide_schema
from recmodels_tpu_torch.models.dcn import DCNModel
from recmodels_tpu_torch.models.deepfm import DeepFMModel
from recmodels_tpu_torch.models.fm import FMModel
from recmodels_tpu_torch.models.xdeepfm import XDeepFMModel

MODEL_REGISTRY = {"fm": FMModel, "deepfm": DeepFMModel, "dcn": DCNModel, "xdeepfm": XDeepFMModel}
NOT_PORTED = ("lr", "pnn", "widedeep", "nfm", "afm")


def build_model(name: str, schema, **kwargs) -> CTRModel:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model '{name}' is not ported yet: ROADMAP.md, queue 1, item 3"
        )
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](schema, **kwargs)


__all__ = ["CTRModel", "wide_schema", "FMModel", "DeepFMModel", "DCNModel", "XDeepFMModel",
           "MODEL_REGISTRY", "build_model"]
