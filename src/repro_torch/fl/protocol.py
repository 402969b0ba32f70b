"""The one-shot FL protocol and its communication ledger
(``repro/fl/protocol.py:51-104,409-431``).

The whole point of one-shot FL is the communication profile: exactly one
client→server model upload per client and nothing broadcast.
``CommLedger`` records every transfer so that a run can show it.
``build_federation`` does the Dirichlet split, the local training and
one upload a client, on the LocalUpdate engine the execution policy
picks (``client_loop``): the grouped engine (``fl/federation.py``, the
default on both profiles, as in the reference's registry) or the
per-client loop (``client_loop_mode="python"``, the reference's
``_build_python_federation``). Fault injection and upload admission are
not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch

from repro_torch.configs.backend import resolve_device, resolve_exec_policy
from repro_torch.core.ensemble import Client
from repro_torch.data.partition import dirichlet_partition
from repro_torch.fl.client import local_update
from repro_torch.models.cnn import CNN, CNNSpec, cnn_init
from repro_torch.models.transformer import leaves

EVENT_KINDS = ("delivered", "dropped", "delayed", "rejected")


def param_bytes(model) -> int:
    """Bytes of what an upload holds: every parameter and BN statistic of
    a module, or every tensor of an LM's nested dict of parameters."""
    tensors = model.state_dict().values() \
        if isinstance(model, torch.nn.Module) else leaves(model)
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclass
class CommLedger:
    events: list = field(default_factory=list)

    def record(self, direction: str, who: str, nbytes: int, what: str,
               kind: str = "delivered"):
        if direction not in ("up", "down"):
            raise ValueError(f"direction must be 'up' or 'down', "
                             f"got {direction!r}")
        if kind not in EVENT_KINDS:
            raise ValueError(f"kind must be one of {EVENT_KINDS}, "
                             f"got {kind!r}")
        self.events.append({"dir": direction, "who": who,
                            "bytes": int(nbytes), "what": what,
                            "kind": kind})

    @property
    def uplink_bytes(self) -> int:
        """Bytes that landed at the server (``delivered`` events)."""
        return sum(e["bytes"] for e in self.events
                   if e["dir"] == "up" and e["kind"] == "delivered")

    @property
    def downlink_bytes(self) -> int:
        return sum(e["bytes"] for e in self.events if e["dir"] == "down")

    @property
    def rounds(self) -> int:
        """Number of distinct up-transfer phases (communication rounds)."""
        return len({e["what"] for e in self.events if e["dir"] == "up"})

    def kinds(self, kind: str, direction: str = "up") -> list:
        return [e for e in self.events if e["dir"] == direction
                and e["kind"] == kind]


def init_model(init_models: Sequence[CNN], i: int, spec: CNNSpec,
               dev: torch.device) -> CNN:
    """Client i's given initial model, checked against its spec and the
    device the federation trains on."""
    model = init_models[i]
    if model.spec != spec:
        raise ValueError(f"init_models[{i}] is {model.spec}, "
                         f"client {i} is {spec}")
    if next(model.parameters()).device != dev:
        raise ValueError(f"init_models[{i}] is not on {dev}")
    return model


def build_federation(scfg, data, *, device="cuda",
                     generator: torch.Generator | None = None,
                     ledger: CommLedger | None = None, seed: int = 0,
                     init_models: Sequence[CNN] | None = None):
    """Partition the data (Dirichlet, §3.1.2), train every client locally
    and upload each model once: the one communication round of DENSE.

    Returns (clients, shards) where shards[i] = (x_i, y_i). Client i
    trains on the minibatch stream seeded ``seed + i``. Its initial model
    is ``init_models[i]`` when given, else drawn from ``generator`` (a
    CPU ``torch.Generator``, seeded ``seed`` when None), in client order
    on both engines. The per-client engine trains a given initial model
    in place; the grouped engine copies it into its group's stack and
    returns a ``fl.federation.ClientList`` of views of the stacks.
    """
    dev = resolve_device(device)
    pol = resolve_exec_policy(scfg, device=dev)  # refuses unported engines
    if scfg.fault_plan or scfg.dropout_frac:
        raise NotImplementedError("upload fault injection is not ported yet"
                                  " (ROADMAP.md, Queue 1 item 6)")
    if pol.client_loop == "grouped":
        from repro_torch.fl.federation import build_grouped_federation
        return build_grouped_federation(
            scfg, data, device=dev, generator=generator, ledger=ledger,
            seed=seed, init_models=init_models)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    x, y = data["train"]
    parts = dirichlet_partition(y, scfg.n_clients, scfg.alpha, seed=seed)
    clients, shards = [], []
    for i, idx in enumerate(parts):
        spec = CNNSpec(kind=scfg.client_kinds[i % len(scfg.client_kinds)],
                       num_classes=scfg.num_classes, in_ch=scfg.in_ch,
                       width=scfg.width, image_size=scfg.image_size)
        if init_models is not None:
            model = init_model(init_models, i, spec, dev)
        else:
            model = cnn_init(spec, generator=generator, device=dev)
        model, info = local_update(
            model, x[idx], y[idx], epochs=scfg.local_epochs,
            lr=scfg.local_lr, momentum=scfg.local_momentum,
            batch_size=scfg.batch_size, use_ldam=scfg.use_ldam,
            num_classes=scfg.num_classes, seed=seed + i)
        if ledger is not None:
            ledger.record("up", f"client{i}", param_bytes(model),
                          "round0-model-upload")
        clients.append(Client(spec=spec, model=model, n_data=len(idx),
                              class_counts=info["class_counts"]))
        shards.append((x[idx], y[idx]))
    return clients, shards
