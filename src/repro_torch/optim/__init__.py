from repro_torch.optim.ldam import class_margins, ldam_loss, ldam_nll
from repro_torch.optim.optimizers import (adam, clip_by_global_norm,
                                          global_norm, sgd)
from repro_torch.optim.schedules import constant, cosine, warmup_cosine

__all__ = ["adam", "class_margins", "clip_by_global_norm", "constant",
           "cosine", "global_norm", "ldam_loss", "ldam_nll", "sgd",
           "warmup_cosine"]
