from repro_torch.optim.optimizers import (adam, clip_by_global_norm,
                                          global_norm, sgd)

__all__ = ["adam", "clip_by_global_norm", "global_norm", "sgd"]
