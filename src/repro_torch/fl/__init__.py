from repro_torch.fl.client import local_update, make_local_step
from repro_torch.fl.fedavg import fedavg
from repro_torch.fl.protocol import CommLedger, build_federation, param_bytes

__all__ = ["CommLedger", "build_federation", "fedavg", "local_update",
           "make_local_step", "param_bytes"]
