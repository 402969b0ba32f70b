from repro_torch.data.partition import class_counts, dirichlet_partition
from repro_torch.data.pipeline import (BatchPlan, batches, bucket_members,
                                        build_batch_plan, lm_batches,
                                        pad_shards, plan_step_waste)
from repro_torch.data.synthetic import make_classification_data, make_lm_data

__all__ = ["BatchPlan", "batches", "bucket_members", "build_batch_plan",
           "class_counts", "dirichlet_partition", "lm_batches",
           "make_classification_data", "make_lm_data", "pad_shards",
           "plan_step_waste"]
