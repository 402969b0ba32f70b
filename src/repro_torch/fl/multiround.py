"""Multi-round DENSE (paper §3.3.4, Table 5; ``repro/fl/multiround.py``).

Homogeneous clients only: every client and the global model are
``scfg.global_kind``, since the server broadcasts one model back. Round
r: every client starts from a copy of the round-(r−1) global model (round
0: its own init), trains ``local_epochs`` on the minibatch stream seeded
``seed·1000 + r·100 + i`` and uploads once; the server runs DENSE with
the student warm-started from the previous global model and broadcasts
the result, except after the last round. Each round's local phase runs
on the engine the execution policy picks: the grouped engine
(``fl/federation.train_clients_grouped``, the default: the n clients as
one stacked network, the stack handed on to the server's teacher as it
is) or the per-client loop (``client_loop_mode="python"``). Each
round's server runs on the epoch driver the policy resolves
(``core/dense.py``): the python driver on the CPU, the fused driver (one
captured epoch, replayed) on a CUDA device, as the reference's
docstring has it; on the card every DENSE step of every round runs the
K1 pair.

With a fault plan (``scfg.fault_plan``, ``scfg.dropout_frac``) each
round's uploads pass the fault and admission boundary
(``fl.faults.apply_upload_faults``, ``fl.protocol.admit_uploads``), as
the reference's do: a ``delay`` fault holds a client's round-r model
back and lands it as its round-(r+1) upload, quarantined clients are
masked out of that round's ensemble, and the broadcast still reaches
every client. The boundary is ``fl.protocol.upload_boundary``, the one
``build_federation`` crosses; round r's corruption is seeded
``fl.faults.fault_seed`` (the reference's ``fault_seed · 7919 + r``).

With ``ensemble_shard_mode="clients"`` every round's grouped local phase
and server teacher run on the client mesh (``fl.sharding.resolve_mesh``,
``repro/fl/multiround.py:43-46``).
"""
from __future__ import annotations

import copy
from typing import Callable, Sequence

import torch

from repro_torch.configs.backend import resolve_device, resolve_exec_policy
from repro_torch.core.dense import train_dense_server
from repro_torch.core.ensemble import Client
from repro_torch.data.partition import dirichlet_partition
from repro_torch.fl.client import local_update
from repro_torch.fl.faults import build_fault_plan
from repro_torch.fl.federation import train_clients_grouped
from repro_torch.fl.protocol import (CommLedger, init_model, param_bytes,
                                     upload_boundary)
from repro_torch.fl.sharding import resolve_mesh
from repro_torch.models.cnn import CNN, CNNSpec, cnn_init


def dense_multi_round(scfg, data, *, rounds: int,
                      ledger: CommLedger | None = None,
                      eval_fn: Callable | None = None, seed: int = 0,
                      device="cuda",
                      init_models: Sequence[CNN] | None = None,
                      server_inputs: Callable | None = None,
                      corrupt: Callable | None = None):
    """Run ``rounds`` rounds of DENSE. Returns (global model, spec,
    [eval_fn(global model, spec) after each round]).

    The data is split as ``build_federation`` splits it (Dirichlet,
    ``seed``). Client i's round-0 model is ``init_models[i]`` (trained in
    place by the per-client engine, copied by the grouped one) when
    given, else drawn from a CPU ``torch.Generator`` seeded
    ``seed``, which then draws each round's generator (and round 0's
    student); the latents come from one device generator seeded ``seed``
    across rounds. ``server_inputs(r) -> dict`` replaces those for round
    r with ``train_dense_server`` keywords (``gen``, ``noise`` and, in
    round 0 only, ``student``; later rounds warm-start from the global
    model): the tests inject the reference's round-r draws there.
    ``corrupt`` is passed on to ``fl.protocol.upload_boundary``.
    """
    dev = resolve_device(device)
    pol = resolve_exec_policy(scfg, device=dev)
    mesh = resolve_mesh(pol, device=dev)
    x, y = data["train"]
    parts = dirichlet_partition(y, scfg.n_clients, scfg.alpha, seed=seed)
    spec = CNNSpec(kind=scfg.global_kind, num_classes=scfg.num_classes,
                   in_ch=scfg.in_ch, width=scfg.width,
                   image_size=scfg.image_size)
    init_gen = torch.Generator().manual_seed(seed)
    draws = torch.Generator(device=dev).manual_seed(seed)
    if init_models is None:
        init_models = [cnn_init(spec, generator=init_gen, device=dev)
                       for _ in parts]
    shards = [(x[idx], y[idx]) for idx in parts]
    global_model, accs = None, []
    pending: dict = {}                  # delayed uploads, one round stale
    for r in range(rounds):
        seeds = [seed * 1000 + r * 100 + i for i in range(len(parts))]
        tag = f"round{r}-model-upload"
        plan = build_fault_plan(scfg, round=r)
        faulty = bool(plan) or bool(pending)
        train_ledger = None if faulty else ledger
        if pol.client_loop == "grouped":
            inits = [init_model(init_models, i, spec, dev)
                     for i in range(len(parts))] if global_model is None \
                else [global_model] * len(parts)
            clients = train_clients_grouped(
                [spec] * len(parts), shards, epochs=scfg.local_epochs,
                lr=scfg.local_lr, momentum=scfg.local_momentum,
                batch_size=scfg.batch_size, use_ldam=False,
                num_classes=scfg.num_classes, seeds=seeds,
                init_models=inits, ledger=train_ledger, upload_tag=tag,
                mesh=mesh)
        else:
            clients = []
            for i, (xi, yi) in enumerate(shards):
                model = init_model(init_models, i, spec, dev) \
                    if global_model is None else copy.deepcopy(global_model)
                model, info = local_update(
                    model, xi, yi, epochs=scfg.local_epochs,
                    lr=scfg.local_lr, momentum=scfg.local_momentum,
                    batch_size=scfg.batch_size,
                    num_classes=scfg.num_classes, seed=seeds[i])
                if train_ledger is not None:
                    train_ledger.record("up", f"client{i}",
                                        param_bytes(model), tag)
                clients.append(Client(spec=spec, model=model,
                                      n_data=len(yi),
                                      class_counts=info["class_counts"]))
        if faulty:
            clients, _, pending = upload_boundary(
                clients, scfg, plan, round=r, ledger=ledger,
                pending=pending, corrupt=corrupt)
        inputs = dict(server_inputs(r)) if server_inputs is not None \
            else {"generator": draws, "init_generator": init_gen}
        if global_model is not None:
            inputs["student"] = global_model
        global_model, _, _ = train_dense_server(clients, scfg, spec,
                                                device=dev, **inputs)
        if ledger is not None and r + 1 < rounds:
            for i in range(scfg.n_clients):
                ledger.record("down", f"client{i}", param_bytes(global_model),
                              f"round{r}-broadcast")
        if eval_fn is not None:
            accs.append(eval_fn(global_model, spec))
    return global_model, spec, accs
