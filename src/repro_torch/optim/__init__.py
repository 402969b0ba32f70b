from repro_torch.optim.ldam import class_margins, ldam_loss
from repro_torch.optim.optimizers import (adam, clip_by_global_norm,
                                          global_norm, sgd)
from repro_torch.optim.schedules import constant, cosine, warmup_cosine

__all__ = ["adam", "class_margins", "clip_by_global_norm", "constant",
           "cosine", "global_norm", "ldam_loss", "sgd", "warmup_cosine"]
