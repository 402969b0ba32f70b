from repro_torch.optim.optimizers import adam, global_norm, sgd

__all__ = ["adam", "global_norm", "sgd"]
