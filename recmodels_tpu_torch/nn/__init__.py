from recmodels_tpu_torch.nn.mlp import mlp_apply, mlp_init

__all__ = ["mlp_init", "mlp_apply"]
