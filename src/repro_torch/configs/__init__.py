from repro_torch.configs.backend import (ExecPolicy, resolve_device,
                                         resolve_exec_policy)
from repro_torch.configs.paper_cifar import (CONFIG, DenseExperimentConfig,
                                             smoke)

__all__ = ["CONFIG", "DenseExperimentConfig", "ExecPolicy", "resolve_device",
           "resolve_exec_policy", "smoke"]
