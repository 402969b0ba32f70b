"""The grouped LocalUpdate engine: the federation's local phase, partition
to upload, one stacked network per architecture
(``repro/fl/federation.py``).

Clients are grouped by ``CNNSpec`` (``group_specs``, the same grouping
the server's ensemble makes) and each group trains as one network
(``fl/client.local_update_grouped``) over one ``BatchPlan`` of every
member's seeded minibatch stream. The stacked weights it trains *are*
the server's grouped representation: ``ClientList.grouped`` hands them
to ``core/ensemble.stack_grouped`` as they are, and ``fl/fedavg.fedavg``
averages the same stack. Each ``Client.model`` is a ``CNN`` viewing its
row of the stack (``models/cnn.cnn_view``), so per-client evaluation
needs no copy.

The execution policy's federation-scale knobs (DESIGN.md §13) reach
the engine here: ``bucketing`` bins each group by batches an epoch and
``stack_chunk`` trains each bin in slices of that many clients
(``fl/client.local_update_bucketed``); the stack comes back in member
order either way. With both off (every profile's default) it is the
single-plan engine, one call a group. With ``ensemble_shard_mode=
"clients"`` each group the client mesh's axis divides trains sharded
over it (``fl/sharding.py``, ``fl/client.local_update_grouped``;
``repro/fl/federation.py:168-180``): the same seeds and the same math,
the stack gathered back whole on every rank.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.backend import resolve_device, resolve_exec_policy
from repro_torch.core.ensemble import Client, group_specs
from repro_torch.data.partition import dirichlet_partition
from repro_torch.fl.client import local_update_bucketed
from repro_torch.models.cnn import CNN, CNNSpec, client_views, cnn_init


class ClientList(list):
    """Per-client ``Client`` views and the grouped representation.

    ``grouped`` is (gspecs, gparams) in ``stack_grouped``'s contract: a
    tuple of (CNNSpec, group size) and one entry a group, the trained
    stack for a group of more than one, the client's ``CNN`` (a view of a
    stack of one) for a singleton.

    Upload admission (``fl.protocol.admit_uploads``) sets the other
    three: ``survivor_mask``, an (m,) numpy bool array (True: admitted);
    ``group_masks``, one entry a group, None where the whole group
    survives, else a numpy bool array over the group's clients; and
    ``quarantined``, {client: reason}. A federation that went through no
    admission has None, None and {}."""

    def __init__(self, clients: Sequence[Client], gspecs, gparams):
        super().__init__(clients)
        self.grouped = (tuple(gspecs), list(gparams))
        self.survivor_mask = None
        self.group_masks = None
        self.quarantined: dict[int, str] = {}


def client_specs(scfg) -> list[CNNSpec]:
    """The federation's client architectures (scfg.client_kinds cycled)."""
    return [CNNSpec(kind=scfg.client_kinds[i % len(scfg.client_kinds)],
                    num_classes=scfg.num_classes, in_ch=scfg.in_ch,
                    width=scfg.width, image_size=scfg.image_size)
            for i in range(scfg.n_clients)]


def train_clients_grouped(specs: Sequence[CNNSpec], shards: Sequence[tuple],
                          *, epochs: int, lr: float, momentum: float,
                          batch_size: int, use_ldam: bool, num_classes: int,
                          seeds: Sequence[int], init_models: Sequence[CNN],
                          n_data: Sequence[int] | None = None,
                          ledger=None,
                          upload_tag: str = "round0-model-upload",
                          policy=None, mesh=None) -> ClientList:
    """The grouped LocalUpdate phase of any federation
    (``repro/fl/federation.py:75-153``).

    specs, shards, seeds and ``init_models`` (client i's initial model;
    copied into its group's stack, never trained in place) are per
    client, in federation order. ``policy`` (an ``ExecPolicy``) routes
    ``bucketing`` and ``stack_chunk`` (module doc); None is both off.
    ``mesh``: a ("clients", "data") mesh; each group its clients axis
    divides trains sharded (``fl/client.local_update_grouped``).
    Records one upload a client, of its own model's bytes, in
    ``ledger``."""
    from repro_torch.fl.protocol import param_bytes  # protocol routes here
    m = len(specs)
    if n_data is None:
        n_data = [len(y) for _, y in shards]
    gspecs, gparams = [], []
    models: list = [None] * m
    counts_view: list = [None] * m
    bucketing = policy.bucketing if policy is not None else "off"
    stack_chunk = policy.stack_chunk if policy is not None else 0
    for spec, idx in group_specs(specs):
        group_shards = [shards[i] for i in idx]
        counts = np.stack([np.bincount(y, minlength=num_classes)
                           for _, y in group_shards])
        stacked = local_update_bucketed(
            lambda j, _idx=idx: init_models[_idx[j]], spec, group_shards,
            batch_size=batch_size, epochs=epochs,
            seeds=[seeds[i] for i in idx], lr=lr, momentum=momentum,
            use_ldam=use_ldam, num_classes=num_classes, class_counts=counts,
            bucketing=bucketing, chunk=stack_chunk, mesh=mesh)
        views = client_views(spec, stacked)
        gspecs.append((spec, len(idx)))
        gparams.append(views[0] if len(idx) == 1 else stacked)
        for j, i in enumerate(idx):
            models[i], counts_view[i] = views[j], counts[j]
            if ledger is not None:
                ledger.record("up", f"client{i}", param_bytes(views[j]),
                              upload_tag)
    clients = [Client(spec=specs[i], model=models[i], n_data=int(n_data[i]),
                      class_counts=counts_view[i]) for i in range(m)]
    return ClientList(clients, gspecs, gparams)


def build_grouped_federation(scfg, data, *, device="cuda",
                             generator: torch.Generator | None = None,
                             ledger=None, seed: int = 0,
                             init_models: Sequence[CNN] | None = None):
    """The grouped engine's ``fl.protocol.build_federation``: Dirichlet
    split, grouped local training, one upload a client.

    Returns (clients, shards), clients a ``ClientList``. Client i's
    initial model is ``init_models[i]`` when given, else drawn from
    ``generator`` (a CPU ``torch.Generator``, seeded ``seed`` when None)
    in client order, and its minibatch stream is seeded ``seed + i``:
    both as the per-client engine draws them, so the two engines agree
    to float tolerance. ``scfg.ensemble_shard_mode="clients"`` trains
    each divisible group sharded over the client mesh."""
    from repro_torch.fl.protocol import init_model
    from repro_torch.fl.sharding import resolve_mesh
    dev = resolve_device(device)
    pol = resolve_exec_policy(scfg, device=dev)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    x, y = data["train"]
    parts = dirichlet_partition(y, scfg.n_clients, scfg.alpha, seed=seed)
    shards = [(x[idx], y[idx]) for idx in parts]
    specs = client_specs(scfg)
    inits = [init_model(init_models, i, spec, dev) if init_models is not None
             else cnn_init(spec, generator=generator, device=dev)
             for i, spec in enumerate(specs)]
    clients = train_clients_grouped(
        specs, shards, epochs=scfg.local_epochs, lr=scfg.local_lr,
        momentum=scfg.local_momentum, batch_size=scfg.batch_size,
        use_ldam=scfg.use_ldam, num_classes=scfg.num_classes,
        seeds=[seed + i for i in range(scfg.n_clients)], init_models=inits,
        ledger=ledger, policy=pol, mesh=resolve_mesh(pol, device=dev))
    return clients, shards


__all__ = ["ClientList", "client_specs", "group_specs",
           "train_clients_grouped", "build_grouped_federation"]
