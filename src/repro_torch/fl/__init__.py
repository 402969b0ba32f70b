from repro_torch.fl.baselines import (fed_adi, fed_dafl, fed_df,
                                      make_distill_step)
from repro_torch.fl.client import local_update, make_local_step
from repro_torch.fl.fedavg import fedavg
from repro_torch.fl.multiround import dense_multi_round
from repro_torch.fl.protocol import CommLedger, build_federation, param_bytes

__all__ = ["CommLedger", "build_federation", "dense_multi_round", "fed_adi",
           "fed_dafl", "fed_df", "fedavg", "local_update", "make_distill_step",
           "make_local_step", "param_bytes"]
