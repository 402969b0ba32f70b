from repro_torch.data.partition import class_counts, dirichlet_partition
from repro_torch.data.pipeline import batches
from repro_torch.data.synthetic import make_classification_data

__all__ = ["batches", "class_counts", "dirichlet_partition",
           "make_classification_data"]
