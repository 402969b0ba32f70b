"""FedAvg aggregation, the paper's primary baseline: θ_S = Σ_k (n_k/n) θ^k
over every parameter and BN statistic (the flat ``fedavg`` of
``repro/fl/fedavg.py:171``). Homogeneous clients only."""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.ensemble import Client
from repro_torch.models.cnn import CNN


def _check_n_data(n_data) -> np.ndarray:
    n = np.asarray(n_data, np.float64)
    if n.size == 0:
        raise ValueError("FedAvg weights are n_k / n; got an empty "
                         "n_data list")
    if np.any(n <= 0):
        bad = [(i, v) for i, v in enumerate(np.asarray(n_data).tolist())
               if v <= 0][:5]
        raise ValueError("FedAvg weights are n_k / n; every client must "
                         f"report n_data > 0, got (client, n_data): {bad}")
    return n


@torch.no_grad()
def fedavg(clients: Sequence[Client]) -> CNN:
    """A new model holding the n_data-weighted average of the clients'
    parameters and BN running statistics, on the clients' device."""
    kinds = {c.spec for c in clients}
    if len(kinds) != 1:
        raise ValueError("FedAvg requires homogeneous client models; got "
                         f"{[c.spec.kind for c in clients]}")
    n = _check_n_data([c.n_data for c in clients])
    out = copy.deepcopy(clients[0].model)
    states = [c.model.state_dict() for c in clients]
    w = torch.tensor(n / n.sum(), dtype=torch.float32,
                     device=next(out.parameters()).device)
    for name, leaf in out.state_dict().items():
        stacked = torch.stack([s[name].float() for s in states])
        wf = w.view((-1,) + (1,) * leaf.dim())
        leaf.copy_((wf * stacked).sum(0))
    return out
