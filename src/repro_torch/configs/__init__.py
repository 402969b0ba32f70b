from repro_torch.configs.backend import (ExecPolicy, resolve_device,
                                         resolve_exec_policy)
from repro_torch.configs.base import (ArchConfig, get_config,
                                      get_smoke_config)
from repro_torch.configs.paper_cifar import (CONFIG, DenseExperimentConfig,
                                             smoke)

__all__ = ["ArchConfig", "CONFIG", "DenseExperimentConfig", "ExecPolicy",
           "get_config", "get_smoke_config", "resolve_device",
           "resolve_exec_policy", "smoke"]
