"""Client-side LocalUpdate (paper §3.1.4: SGD, lr=0.01, momentum=0.9,
b=128, E epochs; ``repro/fl/client.py``), with the CE loss or, for
locally imbalanced shards, the LDAM loss (paper Table 4) at margins from
the shard's class counts. Two engines:

  * ``local_update`` — one client: the python loop over the seeded
    minibatch stream of ``data.pipeline.batches``, one step a minibatch.
  * ``local_update_grouped`` — m same-spec clients as one network
    (``models/cnn.cnn_stack_train_grouped``), stepping through a
    ``data.pipeline.BatchPlan`` whose minibatches are gathered on the
    device. Ragged shards are masked: the CE/LDAM means and the BN batch
    statistics count valid rows only, and on a step where a client has
    no valid row its parameters, momentum and running statistics pass
    through unchanged. It consumes the same per-client streams as the
    loop, so the two agree to float tolerance.
  * ``local_update_bucketed`` — the m = 1000 driver around it
    (DESIGN.md §13): a group's members binned by batches an epoch
    (``data.pipeline.bucket_members``) and each bin trained in slices of
    ``stack_chunk`` clients, so padding steps and the stacked state of
    one call stay small; the trained stack comes back in member order.

On a ("clients", "data") mesh (``fl/sharding.py``, ``mesh=`` or the
policy's ``ensemble_shard``) a group the clients axis divides trains
sharded (``repro/fl/client.py:200-245``): each rank trains its own rows
of the stack, the momentum, the padded shards, the plan and the
margins, with no per-client math crossing ranks, and the trained rows
are all-gathered back into the stack in client order, so the upload,
the ledger and admission see the whole federation as before.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import optim
from repro_torch.data.pipeline import (BatchPlan, batches, bucket_members,
                                       build_batch_plan, pad_shards)
from repro_torch.models.cnn import (CNN, CNNSpec, cat_stacked, cnn_apply,
                                    cnn_stack_train_grouped, is_running_stat,
                                    stack_models, take_stacked)


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


# ------------------------------------------------- grouped local update ---

def make_grouped_local_update(spec: CNNSpec, stacked: dict, *, lr: float,
                              momentum: float, use_ldam: bool = False,
                              margins: torch.Tensor | None = None):
    """One masked SGD (or LDAM) step for a stacked group of m clients
    (``repro/fl/client.py:86-181``), training ``stacked`` in place.

    Returns (step, opt). ``step(bx, by, bmask=None, keep=None)`` takes
    the m minibatches bx (m, B, H, W, C), by (m, B); ``bmask`` (m, B) the
    valid rows (None: all), ``keep`` a host bool array (m,) of the
    clients with a valid row (None: all). It returns the per-client
    losses (m,), 0 where a client has no valid row. The running
    statistics come back from the forward and are written after the
    optimizer step, which never sees them. ``margins`` (m, num_classes)
    are the per-client LDAM margins."""
    if use_ldam and margins is None:
        raise ValueError("use_ldam needs the per-client margins")
    names = [k for k in stacked if not is_running_stat(k)]
    stat_names = [k for k in stacked if is_running_stat(k)]
    params = [stacked[k].requires_grad_(True) for k in names]
    opt = optim.sgd(params, lr, momentum=momentum)

    def per_client_losses(logits, by, bmask):
        if use_ldam:
            nll = optim.ldam_nll(logits, by, margins)
        else:
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = -torch.gather(logp, -1, by.long()[..., None])[..., 0]
        if bmask is None:
            return nll.mean(dim=-1)
        w = bmask.float()
        return (nll * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)

    def step(bx, by, bmask=None, keep=None):
        logits, new_stats, _ = cnn_stack_train_grouped(stacked, spec, bx,
                                                       bmask)
        per = per_client_losses(logits, by, bmask)
        grads = torch.autograd.grad(per.sum(), params)
        with torch.no_grad():
            if keep is not None:
                # no valid row: params, momentum and statistics stay put
                rows = torch.as_tensor(np.nonzero(~keep)[0],
                                       device=bx.device)
                held = [*params, *(opt.bufs or ()),
                        *(stacked[k] for k in stat_names)]
                saved = [t[rows].clone() for t in held]
            opt.step(grads)
            for k in stat_names:
                stacked[k].copy_(new_stats[k])
            if keep is not None:
                for t, v in zip(held, saved):
                    t[rows] = v
                # a client with no valid row may have overflowed: its
                # loss and gradients are dropped, not multiplied by 0
                per = torch.where(torch.as_tensor(keep, device=per.device),
                                  per, torch.zeros_like(per))
        return per.detach()

    return step, opt


def local_update_grouped(stacked: dict, spec: CNNSpec, xs, ys,
                         plan: BatchPlan, *, lr: float = 0.01,
                         momentum: float = 0.9, use_ldam: bool = False,
                         num_classes: int = 10,
                         class_counts: np.ndarray | None = None,
                         mesh=None, policy=None):
    """Train a stacked group of m same-spec clients in place, on the
    stack's device (``repro/fl/client.py:184-242``).

    xs (m, n, H, W, C), ys (m, n): the padded shards
    (``data.pipeline.pad_shards``); plan: their ``BatchPlan``.
    class_counts (m, num_classes): the real shards' label counts (read
    off the plan's first epoch when None); LDAM takes its margins from
    them. Returns (stacked, info) with info["loss"] a (steps, m) tensor
    on the device, 0 on a client's padding steps.

    ``mesh`` (default: ``fl.sharding.resolve_mesh(policy)`` when a
    policy is given): when its clients axis divides m, this rank trains
    its own rows and the stack and the losses are all-gathered back
    (module doc)."""
    from repro_torch.fl.sharding import (client_rows, gather_rows,
                                         group_shardable, resolve_mesh)

    if mesh is None and policy is not None:
        mesh = resolve_mesh(policy)
    dev = next(iter(stacked.values())).device
    m = plan.idx.shape[0]
    if class_counts is None:
        sizes = plan.mask[:, :plan.steps_per_epoch].reshape(m, -1).sum(1)
        class_counts = np.stack(
            [np.bincount(np.asarray(ys[k][:int(sizes[k])]),
                         minlength=num_classes) for k in range(m)])
    if group_shardable(mesh, m):
        lo, hi = client_rows(mesh, m)
        local = {k: v[lo:hi].detach().clone() for k, v in stacked.items()}
        rows = BatchPlan(idx=plan.idx[lo:hi], mask=plan.mask[lo:hi],
                         steps_per_epoch=plan.steps_per_epoch,
                         epochs=plan.epochs, batch_size=plan.batch_size)
        _, info = local_update_grouped(
            local, spec, np.asarray(xs)[lo:hi], np.asarray(ys)[lo:hi], rows,
            lr=lr, momentum=momentum, use_ldam=use_ldam,
            num_classes=num_classes,
            class_counts=np.asarray(class_counts)[lo:hi])
        with torch.no_grad():
            for k, v in stacked.items():
                v.copy_(gather_rows(local[k], mesh))
                v.requires_grad_(local[k].requires_grad)
        loss = gather_rows(info["loss"].T, mesh).T
        return stacked, {"loss": loss, "class_counts": class_counts}
    margins = torch.stack([optim.class_margins(c) for c in class_counts]
                          ).to(dev) if use_ldam else None
    step, _ = make_grouped_local_update(spec, stacked, lr=lr,
                                        momentum=momentum,
                                        use_ldam=use_ldam, margins=margins)
    xs = torch.as_tensor(np.asarray(xs)).to(dev)
    ys = torch.as_tensor(np.asarray(ys)).to(dev)
    idx = torch.as_tensor(plan.idx, dtype=torch.long).to(dev)
    mask = torch.as_tensor(plan.mask).to(dev)
    rows = torch.arange(m, device=dev)[:, None]
    losses = []
    for s in range(plan.steps):
        full = bool(plan.mask[:, s].all())
        keep = plan.mask[:, s].any(-1)
        bi = idx[:, s]
        losses.append(step(xs[rows, bi], ys[rows, bi],
                           None if full else mask[:, s],
                           None if keep.all() else keep))
    loss = torch.stack(losses) if losses else torch.zeros((0, m),
                                                          device=dev)
    return stacked, {"loss": loss, "class_counts": class_counts}


def local_update_bucketed(init_model, spec: CNNSpec, shards, *,
                          batch_size: int, epochs: int, seeds,
                          lr: float = 0.01, momentum: float = 0.9,
                          use_ldam: bool = False, num_classes: int = 10,
                          class_counts: np.ndarray | None = None,
                          bucketing: str = "off", chunk: int = 0,
                          mesh=None) -> dict:
    """Bucketed and chunked LocalUpdate of one architecture group
    (``repro/fl/client.py:245-311``): returns the trained stack, new
    tensors, in member order.

    ``init_model(j)`` is member j's initial ``CNN`` (copied into its
    slice's stack, never trained in place); ``shards``, ``seeds`` and
    ``class_counts`` are per member, in group order. The members are
    binned by batches an epoch (``bucket_members``, ``bucketing``), then
    each bin trains in slices of ``chunk`` clients (all of it at 0) on
    the grouped engine, its shards padded to the bin's largest and its
    plan to the bin's most batches an epoch. The slices are concatenated
    on the device and gathered back to member order, so survivor masks
    and FedAvg weights stay aligned. A client's minibatch stream never
    depends on its bin or slice, and its padding steps change nothing,
    so each client trains as on the single-plan engine, to the float
    tolerance of another batch of stacked convolutions. With
    ``bucketing="off"`` and no chunk it is that engine, one call. Each
    slice the ``mesh``'s clients axis divides trains sharded
    (``local_update_grouped``)."""
    sizes = [len(y) for _, y in shards]
    pieces, order = [], []
    for members in bucket_members(sizes, batch_size, bucketing):
        nb_bucket = max(-(-sizes[j] // batch_size) for j in members)
        pad_n = max(sizes[j] for j in members)
        step = chunk if chunk else len(members)
        for c0 in range(0, len(members), step):
            mem = members[c0:c0 + step]
            stacked = stack_models([init_model(j) for j in mem])
            xs, ys = pad_shards([shards[j] for j in mem], pad_to=pad_n)
            plan = build_batch_plan([sizes[j] for j in mem], batch_size,
                                    epochs=epochs,
                                    seeds=[seeds[j] for j in mem],
                                    steps_per_epoch=nb_bucket)
            cc = None if class_counts is None else \
                np.asarray(class_counts)[list(mem)]
            local_update_grouped(stacked, spec, xs, ys, plan, lr=lr,
                                 momentum=momentum, use_ldam=use_ldam,
                                 num_classes=num_classes, class_counts=cc,
                                 mesh=mesh)
            pieces.append(stacked)
            order.extend(mem)
    stacked = pieces[0] if len(pieces) == 1 else cat_stacked(pieces)
    if order != list(range(len(shards))):
        stacked = take_stacked(stacked, np.argsort(np.asarray(order)))
    return stacked
