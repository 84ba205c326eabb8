from recmodels_tpu_torch.embedding.collection import ALLOC_MULTIPLE, DimGroup, EmbeddingCollection, build_groups
from recmodels_tpu_torch.embedding.gather import gather_rows, gather_rows_reference

__all__ = ["ALLOC_MULTIPLE", "DimGroup", "EmbeddingCollection", "build_groups", "gather_rows", "gather_rows_reference"]
