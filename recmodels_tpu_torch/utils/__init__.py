from recmodels_tpu_torch.utils.config import TrainConfig, build_schema

__all__ = ["TrainConfig", "build_schema"]
