"""LDAM loss (Cao et al. 2019; ``repro/optim/ldam.py``): the paper
combines it with DENSE (Table 4, DENSE+LDAM) for locally imbalanced
client data."""
from __future__ import annotations

import numpy as np
import torch


def class_margins(class_counts, max_margin: float = 0.5) -> torch.Tensor:
    """m_c proportional to n_c^{-1/4}, normalized so max(m) = max_margin.
    ``class_counts`` is a tensor or array of per-class counts; the
    margins are float32, on the tensor's device."""
    if isinstance(class_counts, np.ndarray):
        class_counts = torch.from_numpy(class_counts)
    counts = torch.clamp(class_counts.float(), min=1.0)
    m = 1.0 / torch.sqrt(torch.sqrt(counts))
    return m * (max_margin / torch.max(m))


def ldam_nll(logits: torch.Tensor, labels: torch.Tensor,
             margins: torch.Tensor, s: float = 30.0) -> torch.Tensor:
    """Per-row margin-adjusted CE: subtract m_y from the true-class
    logit, scale by s. logits (..., B, K), labels (..., B), margins
    (..., K): a leading client axis takes each client's own margins."""
    onehot = torch.nn.functional.one_hot(
        labels.long(), logits.shape[-1]).to(logits.dtype)
    adj = logits - onehot * margins.unsqueeze(-2).to(logits.dtype)
    logp = torch.log_softmax(s * adj, dim=-1)
    return -torch.sum(onehot * logp, dim=-1)


def ldam_loss(logits: torch.Tensor, labels: torch.Tensor,
              margins: torch.Tensor, s: float = 30.0,
              sample_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The batch mean of ``ldam_nll``. ``sample_mask`` ((B,) bool): the
    mean over valid rows only; None is the plain batch mean."""
    nll = ldam_nll(logits, labels, margins, s)
    if sample_mask is None:
        return torch.mean(nll)
    w = sample_mask.to(nll.dtype)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
