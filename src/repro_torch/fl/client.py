"""Client-side LocalUpdate (paper §3.1.4: SGD, lr=0.01, momentum=0.9,
b=128, E epochs; ``repro/fl/client.py:39-83``).

The per-client python loop over the seeded minibatch stream of
``data.pipeline.batches``, one step per minibatch, with the CE loss or,
for locally imbalanced shards, the LDAM loss (paper Table 4) at margins
from the shard's class counts. The grouped engine is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import optim
from repro_torch.data.pipeline import batches
from repro_torch.models.cnn import CNN, cnn_apply


def make_local_step(model: CNN, *, lr: float, momentum: float,
                    use_ldam: bool = False,
                    margins: torch.Tensor | None = None):
    """One LocalUpdate step for ``model``: returns (step, opt) where
    ``step(x, y) -> loss`` trains the model in place (BN running
    statistics included). ``use_ldam`` takes the LDAM loss at
    ``margins`` ((num_classes,), ``optim.class_margins``) in place of
    CE."""
    if use_ldam and margins is None:
        raise ValueError("use_ldam needs the per-class margins")
    opt = optim.sgd(list(model.parameters()), lr, momentum=momentum)

    def step(x, y):
        logits, _ = cnn_apply(model, x, train=True, with_stats=False)
        if use_ldam:
            loss = optim.ldam_loss(logits, y, margins)
        else:
            loss = F.cross_entropy(logits.float(), y.long())
        opt.step(torch.autograd.grad(loss, opt.params))
        return loss.detach()

    return step, opt


def local_update(model: CNN, x: np.ndarray, y: np.ndarray, *, epochs: int,
                 lr: float = 0.01, momentum: float = 0.9,
                 batch_size: int = 128, use_ldam: bool = False,
                 num_classes: int = 10, seed: int = 0):
    """Train a client's model on its local shard, in place, on the
    model's device. Returns (model, info)."""
    dev = next(model.parameters()).device
    counts = np.bincount(y, minlength=num_classes)
    margins = optim.class_margins(counts).to(dev) if use_ldam else None
    step, _ = make_local_step(model, lr=lr, momentum=momentum,
                              use_ldam=use_ldam, margins=margins)
    losses = [step(torch.from_numpy(bx).to(dev), torch.from_numpy(by).to(dev))
              for bx, by in batches(x, y, batch_size, seed=seed,
                                    epochs=epochs)]
    loss_list = torch.stack(losses).tolist() if losses else []
    return model, {"loss": loss_list, "class_counts": counts}
