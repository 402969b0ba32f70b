"""Heterogeneous one-shot FL (``examples/hetero_oneshot.py``; paper
Table 2): every client has a different architecture, so FedAvg is
impossible, and DENSE distills the mixed ensemble into a server-chosen
global model. The clients train on the default engine, the grouped one;
with three architectures every group is a singleton, as in the
reference's example.

    PYTHONPATH=src python -m repro_torch.launch.hetero_oneshot [--device cpu]

Runs on the card unless ``--device cpu`` is given, in float32 without
TF32 (``parse_device`` calls ``configs.backend.full_float32``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import smoke
from repro_torch.core import evaluate, train_dense_server
from repro_torch.data import make_classification_data
from repro_torch.fl import build_federation, fedavg
from repro_torch.launch.quickstart import parse_device, server_generators


def config():
    return dataclasses.replace(
        smoke(), n_clients=3, client_kinds=("cnn1", "cnn2", "wrn16_1"),
        global_kind="wrn16_1", epochs=30, t_g=4, s_steps=6)


def main(argv=None):
    dev = parse_device(argv, __doc__)
    scfg = config()
    data = make_classification_data(
        1, num_classes=scfg.num_classes, size=scfg.image_size,
        ch=scfg.in_ch, train_per_class=scfg.train_per_class,
        test_per_class=scfg.test_per_class)
    xt, yt = data["test"]
    clients, _ = build_federation(scfg, data, device=dev)
    for c in clients:
        print(f"client arch={c.spec.kind:9s} n={c.n_data:4d} "
              f"acc={evaluate(c.model, xt, yt):.3f}")

    try:
        fedavg(clients)
    except ValueError as e:
        print(f"FedAvg refuses (as it must): {e}")

    stu, _, _ = train_dense_server(clients, scfg, device=dev,
                                   **server_generators(dev))
    print(f"DENSE global ({scfg.global_kind}) acc: "
          f"{evaluate(stu, xt, yt):.3f}")


if __name__ == "__main__":
    main()
