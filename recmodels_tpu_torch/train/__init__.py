from recmodels_tpu_torch.train.metrics import AUCState, auc_compute, auc_init, auc_update
from recmodels_tpu_torch.train.engine import Engine, LocalTables, TrainState

__all__ = ["AUCState", "auc_init", "auc_update", "auc_compute", "Engine", "LocalTables", "TrainState"]
