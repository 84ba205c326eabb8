"""Model registry (port of ``recmodels_tpu/models/__init__.py``): the nine
models of the JAX zoo under the same names, and the port's own models of
multi-hot pooled slots: DLRM-DCNv2 (``dlrm_dcnv2``: low-rank DCN-V2 cross
layers) and Wukong (``wukong``: stacked FM and linear-compress layers with
residual LayerNorm)."""

from recmodels_tpu_torch.models.afm import AFMModel
from recmodels_tpu_torch.models.base import CTRModel, wide_schema
from recmodels_tpu_torch.models.dcn import DCNModel
from recmodels_tpu_torch.models.deepfm import DeepFMModel
from recmodels_tpu_torch.models.dlrm_dcnv2 import DLRMDCNv2Model
from recmodels_tpu_torch.models.fm import FMModel
from recmodels_tpu_torch.models.lr import LRModel
from recmodels_tpu_torch.models.nfm import NFMModel
from recmodels_tpu_torch.models.pnn import PNNModel
from recmodels_tpu_torch.models.widedeep import WideDeepModel
from recmodels_tpu_torch.models.wukong import WukongModel
from recmodels_tpu_torch.models.xdeepfm import XDeepFMModel

MODEL_REGISTRY = {
    "lr": LRModel,
    "fm": FMModel,
    "deepfm": DeepFMModel,
    "pnn": PNNModel,
    "dcn": DCNModel,
    "xdeepfm": XDeepFMModel,
    "widedeep": WideDeepModel,
    "nfm": NFMModel,
    "afm": AFMModel,
    "dlrm_dcnv2": DLRMDCNv2Model,
    "wukong": WukongModel,
}


def build_model(name: str, schema, **kwargs) -> CTRModel:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](schema, **kwargs)


__all__ = ["CTRModel", "wide_schema", "LRModel", "FMModel", "DeepFMModel", "PNNModel", "DCNModel",
           "XDeepFMModel", "WideDeepModel", "NFMModel", "AFMModel", "DLRMDCNv2Model",
           "WukongModel", "MODEL_REGISTRY", "build_model"]
