"""The one-shot FL protocol, its communication ledger and the server's
upload admission (``repro/fl/protocol.py``).

The whole point of one-shot FL is the communication profile: exactly one
client→server model upload per client and nothing broadcast.
``CommLedger`` records every transfer so that a run can show it. Under
upload faults (``fl/faults.py``) every client still gets exactly one up
event a round, whose ``kind`` tells ``delivered`` (counted in
``uplink_bytes``) from ``dropped``/``delayed`` (the bytes never landed)
and ``rejected`` (quarantined at admission: a zero-byte marker beside
the delivered event).

``build_federation`` does the Dirichlet split, the local training and
one upload a client, on the LocalUpdate engine the execution policy
picks (``client_loop``): the grouped engine (``fl/federation.py``, the
default on both profiles, as in the reference's registry) or the
per-client loop (``client_loop_mode="python"``, the reference's
``_build_python_federation``). With a fault plan (``scfg.fault_plan``,
``scfg.dropout_frac``) the clients train ledger-silent and the upload
boundary (``upload_boundary``: ``fl.faults.apply_upload_faults``, then
``admit_uploads``) writes the ledger; ``fl/multiround.py`` crosses the
same boundary every round.

Admission (``admit_uploads``, DESIGN.md §10) screens every arrived
upload: its tensors' names and shapes against its architecture and
their finiteness (``validate_upload``), then the opt-in parameter-norm
screen (``scfg.norm_screen``, ``norm_outliers``) and the opt-in
leave-one-out cosine screen (``scfg.cos_screen``,
``direction_outliers``). ``scfg.upload_policy`` says what a failed
screen means: ``"quarantine"`` masks the client out
(``survivor_mask``/``group_masks``, read by ``stack_grouped`` and
``fedavg``) and zero-fills its stacked slot; ``"strict"`` raises
``UploadError``. Fewer than ``ceil(scfg.quorum · m)`` survivors raise
``QuorumError`` under either policy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.configs.backend import resolve_device, resolve_exec_policy
from repro_torch.core.ensemble import Client
from repro_torch.data.partition import dirichlet_partition
from repro_torch.fl.client import local_update
from repro_torch.fl.faults import (apply_upload_faults, build_fault_plan,
                                   fault_seed, rebuild_clients)
from repro_torch.models.cnn import CNN, CNNSpec, cnn_init, cnn_view
from repro_torch.models.transformer import leaves

EVENT_KINDS = ("delivered", "dropped", "delayed", "rejected")


def param_bytes(model) -> int:
    """Bytes of what an upload holds: every parameter and BN statistic of
    a module, or every tensor of an LM's nested dict of parameters."""
    tensors = model.state_dict().values() \
        if isinstance(model, torch.nn.Module) else leaves(model)
    return sum(t.numel() * t.element_size() for t in tensors)


class UploadError(ValueError):
    """An upload failed admission under ``upload_policy="strict"``."""


class QuorumError(RuntimeError):
    """Fewer than ``quorum · m`` uploads survived admission."""


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


# ------------------------------------------------------------ admission ---

_TEMPLATES: dict = {}


def _template(spec: CNNSpec) -> dict:
    """{name: shape} of one architecture's upload, from a model built on
    the meta device (no memory, no draws), cached per spec."""
    if spec not in _TEMPLATES:
        with torch.device("meta"):
            tpl = CNN(spec, generator=None)
        _TEMPLATES[spec] = {k: tuple(v.shape)
                            for k, v in tpl.net.state_dict().items()}
    return _TEMPLATES[spec]


def _shape_reason(model, spec: CNNSpec) -> str | None:
    if not isinstance(model, CNN):
        return f"upload is a {type(model).__name__}, not a CNN"
    state = model.net.state_dict()
    tpl = _template(spec)
    if list(state) != list(tpl):
        return f"treedef mismatch vs {spec.kind} template"
    for name, shape in tpl.items():
        if tuple(state[name].shape) != shape:
            return (f"shape mismatch vs {spec.kind} template: "
                    f"got {tuple(state[name].shape)}, want {shape}")
    return None


def _all_finite(model: CNN) -> torch.Tensor:
    """A 0-d bool on the model's device: every float tensor finite."""
    return torch.stack([torch.isfinite(t).all()
                        for t in model.net.state_dict().values()
                        if t.is_floating_point()]).all()


def validate_upload(model, spec: CNNSpec) -> str | None:
    """The name/shape and finite screen of one upload: None when it is
    admissible, else the reason (one host read)."""
    reason = _shape_reason(model, spec)
    if reason is None and not bool(_all_finite(model)):
        reason = "non-finite parameters"
    return reason


def _cohorts(clients, candidates) -> dict:
    cohorts: dict[CNNSpec, list[int]] = {}
    for i in candidates:
        cohorts.setdefault(clients[i].spec, []).append(i)
    return cohorts


def norm_outliers(clients, candidates, threshold: float) -> dict[int, str]:
    """The MAD parameter-norm screen over same-spec cohorts of at least 5
    candidates: a client whose global norm (every tensor of its upload)
    lies more than ``threshold`` median absolute deviations from its
    cohort's median is flagged. A sign flip keeps its norm and passes
    (``direction_outliers`` catches it)."""
    from repro_torch.optim import global_norm
    out: dict[int, str] = {}
    for idx in _cohorts(clients, candidates).values():
        if len(idx) < 5:
            continue
        norms = torch.stack([
            global_norm(clients[i].model.net.state_dict().values())
            for i in idx]).double().cpu().numpy()        # one host read
        med = np.median(norms)
        mad = np.median(np.abs(norms - med))
        if mad == 0.0:
            continue
        for i, n in zip(idx, norms):
            dev = abs(n - med) / mad
            if dev > threshold:
                out[i] = (f"param-norm outlier: {n:.3g} is {dev:.1f} MADs "
                          f"from cohort median {med:.3g}")
    return out


def _flat64(model: CNN) -> np.ndarray:
    return np.concatenate([t.detach().cpu().numpy().astype(np.float64)
                           .ravel()
                           for t in model.net.state_dict().values()])


def direction_outliers(clients, candidates,
                       threshold: float) -> dict[int, str]:
    """The leave-one-out cohort-mean cosine screen, over same-spec
    cohorts of at least 5 candidates: client i is flagged when
    cos(p_i, S − p_i) < ``threshold``, S the cohort's sum, in float64 on
    the host. Two passes over the cohort (the sum, then each cosine)
    keep host memory at O(P), one flattened upload and the sum, never
    O(m·P). A negated upload points away from its trained peers (cosine
    near −1); raw random inits do not cluster, so the screen is opt-in."""
    out: dict[int, str] = {}
    for idx in _cohorts(clients, candidates).values():
        if len(idx) < 5:
            continue
        s = None
        for i in idx:                     # pass 1: the cohort's sum
            v = _flat64(clients[i].model)
            s = v if s is None else s + v
        for i in idx:                     # pass 2: leave-one-out cosines
            v = _flat64(clients[i].model)
            loo = s - v
            nv, nl = np.linalg.norm(v), np.linalg.norm(loo)
            if nv == 0.0 or nl == 0.0:
                continue
            cos = float(np.dot(v, loo) / (nv * nl))
            if cos < threshold:
                out[i] = (f"direction outlier: cosine {cos:.3f} to "
                          f"leave-one-out cohort mean < "
                          f"threshold {threshold}")
    return out


def _zero_like(model: CNN) -> CNN:
    return cnn_view(model.spec, {k: torch.zeros_like(v) for k, v in
                                 model.net.state_dict().items()})


def admit_uploads(clients, *, arrived=None, scfg=None,
                  upload_policy: str | None = None,
                  quorum: float | None = None,
                  norm_screen: float | None = None,
                  cos_screen: float | None = None,
                  ledger: CommLedger | None = None,
                  upload_tag: str = "round0-model-upload"):
    """Screen every arrived upload and build the survivor-masked
    federation: a ``fl.federation.ClientList`` with ``survivor_mask``,
    ``group_masks`` and ``quarantined`` set (see there).

    A quarantined or missing client keeps its ``Client`` entry, with its
    upload and its stacked slot zero-filled, so NaN and Inf reach no
    consumer. ``stack_grouped`` slices the masked clients out, so the
    teacher, the baselines and ``fedavg`` compute exactly what a
    federation built without them computes. The finite screen reads the
    host once for the whole admission; the keyword arguments override
    ``scfg``'s knobs."""
    from repro_torch.core.ensemble import group_clients, stack_grouped
    from repro_torch.fl.federation import ClientList

    policy = upload_policy if upload_policy is not None else \
        getattr(scfg, "upload_policy", "quarantine")
    if policy not in ("strict", "quarantine"):
        raise ValueError(f"upload_policy must be 'strict' or 'quarantine', "
                         f"got {policy!r}")
    q = quorum if quorum is not None else getattr(scfg, "quorum", 0.5)
    screen = norm_screen if norm_screen is not None else \
        getattr(scfg, "norm_screen", 0.0)
    cscreen = cos_screen if cos_screen is not None else \
        getattr(scfg, "cos_screen", None)

    m = len(clients)
    arrived = np.ones(m, bool) if arrived is None else np.asarray(
        arrived, bool)
    quarantined: dict[int, str] = {}
    checked, flags = [], []
    for i in range(m):
        if not arrived[i]:
            quarantined[i] = "upload never arrived"
            continue
        reason = _shape_reason(clients[i].model, clients[i].spec)
        if reason is not None:
            quarantined[i] = reason
        else:
            checked.append(i)
            flags.append(_all_finite(clients[i].model))
    if flags:
        finite = torch.stack([f.to(flags[0].device)
                              for f in flags]).cpu().numpy()
        for i, ok in zip(checked, finite):
            if not ok:
                quarantined[i] = "non-finite parameters"
    if screen and screen > 0:
        ok = [i for i in range(m) if i not in quarantined]
        quarantined.update(norm_outliers(clients, ok, float(screen)))
    if cscreen is not None:
        ok = [i for i in range(m) if i not in quarantined]
        quarantined.update(direction_outliers(clients, ok, float(cscreen)))

    rejected = {i: r for i, r in quarantined.items() if arrived[i]}
    if policy == "strict" and rejected:
        i, reason = min(rejected.items())
        raise UploadError(
            f"client{i} upload failed admission under strict policy: "
            f"{reason}")
    if ledger is not None:
        # zero-byte markers under the same tag: the upload's bytes are on
        # its delivered event, and a new tag would add a round
        for i in sorted(rejected):
            ledger.record("up", f"client{i}", 0, upload_tag,
                          kind="rejected")

    survivor = np.array([i not in quarantined for i in range(m)], bool)
    need = math.ceil(q * m)
    if int(survivor.sum()) < need:
        raise QuorumError(
            f"quorum failure: {int(survivor.sum())}/{m} uploads survived "
            f"admission, need >= {need} (quorum={q}); quarantined: "
            f"{dict(sorted(quarantined.items()))}")

    if survivor.all():
        out = ClientList(list(clients), *stack_grouped(clients))
        out.group_masks = [None] * len(out.grouped[0])
    else:
        out = rebuild_clients(clients, [
            _zero_like(c.model) if i in quarantined else c.model
            for i, c in enumerate(clients)])
        out.group_masks = [None if survivor[list(idx)].all()
                           else survivor[list(idx)]
                           for _, idx in group_clients(out)]
    out.survivor_mask = survivor
    out.quarantined = quarantined
    return out


def upload_boundary(clients, scfg, plan, *, round: int = 0,
                    ledger: CommLedger | None = None,
                    pending: dict | None = None,
                    corrupt: Callable | None = None):
    """Round ``round``'s upload boundary, for clients that trained
    ledger-silent: ``plan`` (``fl.faults.build_fault_plan``) and the
    previous round's ``pending`` uploads applied by
    ``fl.faults.apply_upload_faults`` (seeded ``fl.faults.fault_seed``,
    ``corrupt`` passed on), then ``admit_uploads``. Returns (admitted
    clients, arrived, delayed); the ledger records what happened to each
    upload (``repro/fl/protocol.py:393-403``)."""
    tag = f"round{round}-model-upload"
    clients, arrived, delayed = apply_upload_faults(
        clients, plan, seed=fault_seed(scfg, round), ledger=ledger,
        upload_tag=tag, pending=pending, corrupt=corrupt)
    clients = admit_uploads(clients, arrived=arrived, scfg=scfg,
                            ledger=ledger, upload_tag=tag)
    return clients, arrived, delayed


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
                     init_models: Sequence[CNN] | None = None,
                     round: int = 0, pending: dict | None = None,
                     return_faults: bool = False,
                     corrupt: Callable | None = None):
    """Partition the data (Dirichlet, §3.1.2), train every client locally
    and upload each model once: the one communication round of DENSE.

    Returns (clients, shards) where shards[i] = (x_i, y_i). Client i
    trains on the minibatch stream seeded ``seed + i``. Its initial model
    is ``init_models[i]`` when given, else drawn from ``generator`` (a
    CPU ``torch.Generator``, seeded ``seed`` when None), in client order
    on both engines. The per-client engine trains a given initial model
    in place; the grouped engine copies it into its group's stack and
    returns a ``fl.federation.ClientList`` of views of the stacks.

    With a fault plan for ``round`` (``fl.faults.build_fault_plan``) or
    ``pending`` (the previous round's delayed uploads), the clients train
    ledger-silent and cross ``upload_boundary``: the ledger then records
    what happened to each upload, and the clients come back as the
    admitted ``ClientList``. ``return_faults=True`` also returns
    (arrived, delayed). Without faults nothing changes.
    """
    dev = resolve_device(device)
    pol = resolve_exec_policy(scfg, device=dev)
    plan = build_fault_plan(scfg, round=round)
    faulty = bool(plan) or bool(pending)
    train_ledger = None if faulty else ledger
    if pol.client_loop == "grouped":
        from repro_torch.fl.federation import build_grouped_federation
        clients, shards = build_grouped_federation(
            scfg, data, device=dev, generator=generator, ledger=train_ledger,
            seed=seed, init_models=init_models)
    else:
        clients, shards = _build_python_federation(
            scfg, data, dev=dev, generator=generator, ledger=train_ledger,
            seed=seed, init_models=init_models)
    if not faulty:
        if return_faults:
            return clients, shards, (np.ones(len(clients), bool), {})
        return clients, shards
    clients, arrived, delayed = upload_boundary(
        clients, scfg, plan, round=round, ledger=ledger, pending=pending,
        corrupt=corrupt)
    if return_faults:
        return clients, shards, (arrived, delayed)
    return clients, shards


def _build_python_federation(scfg, data, *, dev, generator, ledger, seed,
                             init_models):
    """The per-client LocalUpdate loop (the reference's ground truth)."""
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
