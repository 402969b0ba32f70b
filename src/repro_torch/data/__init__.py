from repro_torch.data.partition import class_counts, dirichlet_partition
from repro_torch.data.pipeline import batches, lm_batches
from repro_torch.data.synthetic import make_classification_data, make_lm_data

__all__ = ["batches", "class_counts", "dirichlet_partition", "lm_batches",
           "make_classification_data", "make_lm_data"]
