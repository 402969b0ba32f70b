"""Quickstart (``examples/quickstart.py``): data-free one-shot FL with
DENSE.

Builds a 3-client non-IID federation on procedural image data, trains
the clients locally, uploads their models once (the single communication
round), and runs DENSE's two server stages. Compares against one-shot
FedAvg. The three cnn1 clients train on the default engine, the grouped
one, as one stacked network, which the server's teacher and FedAvg then
read as it is (pin ``client_loop_mode="python"`` in ``config()`` for the
per-client loop).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Runs on the card unless ``--device cpu`` is given, in float32 without
TF32 (``configs.backend.full_float32``). The reference keys
its server with ``PRNGKey(1)``; here the server's init and latent
generators are seeded 1.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import resolve_device, smoke
from repro_torch.configs.backend import full_float32
from repro_torch.core import evaluate, train_dense_server
from repro_torch.data import make_classification_data
from repro_torch.fl import CommLedger, build_federation, fedavg

SERVER_SEED = 1


def config():
    return dataclasses.replace(smoke(), epochs=80, t_g=5, s_steps=8)


def server_generators(dev: torch.device) -> dict:
    """``train_dense_server``'s init and latent generators, seeded
    ``SERVER_SEED``."""
    return {"init_generator": torch.Generator().manual_seed(SERVER_SEED),
            "generator": torch.Generator(device=dev).manual_seed(SERVER_SEED)}


def parse_device(argv, doc: str) -> torch.device:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain path")
    dev = resolve_device(ap.parse_args(argv).device)
    full_float32()
    return dev


def main(argv=None):
    dev = parse_device(argv, __doc__)
    scfg = config()
    print(f"federation: {scfg.n_clients} clients, Dirichlet α={scfg.alpha}")

    data = make_classification_data(
        0, num_classes=scfg.num_classes, size=scfg.image_size,
        ch=scfg.in_ch, train_per_class=scfg.train_per_class,
        test_per_class=scfg.test_per_class)
    xt, yt = data["test"]

    # --- the one and only communication round -------------------------
    ledger = CommLedger()
    clients, _ = build_federation(scfg, data, device=dev, ledger=ledger)
    print(f"one-shot upload: {ledger.uplink_bytes/1e6:.2f} MB total, "
          f"{ledger.rounds} round, downlink={ledger.downlink_bytes} B")
    for i, c in enumerate(clients):
        print(f"  client{i}: n={c.n_data:4d} "
              f"local acc={evaluate(c.model, xt, yt):.3f}")

    # --- baseline: parameter averaging ---------------------------------
    acc_avg = evaluate(fedavg(clients), xt, yt)
    print(f"one-shot FedAvg acc: {acc_avg:.3f}")

    # --- DENSE: generator stage + distillation stage -------------------
    stu, gen, hist = train_dense_server(clients, scfg, device=dev,
                                        **server_generators(dev))
    acc = evaluate(stu, xt, yt)
    print(f"DENSE global model acc: {acc:.3f}")
    print(f"generator losses (last epoch): "
          f"CE={hist.gen_parts[-1]['ce']:.3f} "
          f"BN={hist.gen_parts[-1]['bn']:.3f} "
          f"div={hist.gen_parts[-1]['div']:.3f}")


if __name__ == "__main__":
    main()
