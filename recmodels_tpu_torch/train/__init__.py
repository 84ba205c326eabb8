from recmodels_tpu_torch.train.engine import Engine, LocalTables, TrainState

__all__ = ["Engine", "LocalTables", "TrainState"]
