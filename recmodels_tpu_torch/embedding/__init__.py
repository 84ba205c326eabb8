from recmodels_tpu_torch.embedding.bag import bag_gather, bag_gather_reference
from recmodels_tpu_torch.embedding.collection import ALLOC_MULTIPLE, DimGroup, EmbeddingCollection, build_groups
from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference
from recmodels_tpu_torch.embedding.optim import SparseOptimizer, dedup_segment_sum, sparse_adagrad, sparse_adam

__all__ = ["bag_gather", "bag_gather_reference", "ALLOC_MULTIPLE", "DimGroup", "EmbeddingCollection", "build_groups", "gather_rows", "gather_rows_reference",
           "SparseOptimizer", "sparse_adagrad", "sparse_adam", "dedup_segment_sum"]
