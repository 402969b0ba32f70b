"""The client ensemble (Eq. 1: average logits; ``repro/core/ensemble.py``).

Averaging logits, never parameters, is what lets DENSE take clients of
different architectures. This is the reference's looped
``ensemble_logits``: one forward per client, in eval mode. The grouped
and stacked fast paths are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.models.cnn import CNN, CNNSpec, cnn_apply


@dataclass
class Client:
    spec: CNNSpec
    model: CNN
    n_data: int = 0                 # |D_k| (FedAvg weighting; DENSE ignores)
    class_counts: np.ndarray | None = None


def ensemble_logits(models: Sequence[CNN], x: torch.Tensor, *,
                    with_bn_stats: bool = False):
    """Eq. (1): D(x) = (1/m) Σ_k f^k(x), eval-mode BN (running stats).

    ``with_bn_stats`` also returns each client's per-BN-layer batch
    statistics of x, the inputs to L_BN (Eq. 3)."""
    logits_sum, all_stats = None, []
    for model in models:
        lg, stats = cnn_apply(model, x, train=False,
                              with_stats=with_bn_stats)
        lg = lg.float()
        logits_sum = lg if logits_sum is None else logits_sum + lg
        if with_bn_stats:
            all_stats.append(stats)
    avg = logits_sum / len(models)
    return (avg, all_stats) if with_bn_stats else avg
