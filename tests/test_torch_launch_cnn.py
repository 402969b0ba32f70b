"""The CNN entry points, ``python -m repro_torch.launch.quickstart`` and
``... .hetero_oneshot`` (``examples/quickstart.py``,
``examples/hetero_oneshot.py``), on the CPU at smoke size: their
``config()`` is cut to a few epochs at 8x8, and each prints the
example's lines. The federation lines hold the reference's Dirichlet
split of the same data (``repro.data``)."""
import dataclasses
import re

import pytest

from repro.data import dirichlet_partition as r_partition
from repro.data import make_classification_data as r_make_data

from repro_torch.launch import hetero_oneshot, quickstart

TINY = dict(local_epochs=1, batch_size=32, train_per_class=16,
            test_per_class=8, image_size=8, width=0.25, t_g=1, epochs=2,
            s_steps=2, synth_batch=16, nz=16)


def _run(module, monkeypatch, capsys):
    cfg = dataclasses.replace(module.config(), **TINY)
    monkeypatch.setattr(module, "config", lambda: cfg)
    module.main(["--device", "cpu"])
    return cfg, capsys.readouterr().out.splitlines()


def _accs(lines):
    return [float(a) for ln in lines
            for a in re.findall(r"acc[=:]\s*([0-9.]+)", ln)]


def _reference_sizes(seed, cfg):
    _, y = r_make_data(seed, num_classes=cfg.num_classes,
                       size=cfg.image_size, ch=cfg.in_ch,
                       train_per_class=cfg.train_per_class,
                       test_per_class=cfg.test_per_class)["train"]
    return [len(p) for p in r_partition(y, cfg.n_clients, cfg.alpha,
                                        seed=0)]


def test_examples_keep_their_configs():
    q, h = quickstart.config(), hetero_oneshot.config()
    assert (q.epochs, q.t_g, q.s_steps, q.client_kinds) == \
        (80, 5, 8, ("cnn1",) * 3)
    assert (h.epochs, h.t_g, h.s_steps, h.global_kind, h.client_kinds) == \
        (30, 4, 6, "wrn16_1", ("cnn1", "cnn2", "wrn16_1"))


def test_quickstart_prints_its_lines(monkeypatch, capsys):
    cfg, lines = _run(quickstart, monkeypatch, capsys)
    assert lines[0] == f"federation: 3 clients, Dirichlet α={cfg.alpha}"
    assert re.fullmatch(r"one-shot upload: [0-9.]+ MB total, 1 round, "
                        r"downlink=0 B", lines[1])
    ns = [int(re.search(r"n=\s*(\d+)", ln).group(1)) for ln in lines[2:5]]
    assert ns == _reference_sizes(0, cfg)
    assert lines[5].startswith("one-shot FedAvg acc: ")
    assert lines[6].startswith("DENSE global model acc: ")
    assert re.fullmatch(r"generator losses \(last epoch\): CE=\S+ BN=\S+ "
                        r"div=\S+", lines[7])
    accs = _accs(lines)
    assert len(accs) == 5 and all(0.0 <= a <= 1.0 for a in accs)
    assert len(lines) == 8


def test_hetero_oneshot_prints_its_lines(monkeypatch, capsys):
    cfg, lines = _run(hetero_oneshot, monkeypatch, capsys)
    kinds = [re.search(r"arch=(\S+)", ln).group(1) for ln in lines[:3]]
    assert kinds == ["cnn1", "cnn2", "wrn16_1"]
    ns = [int(re.search(r"n=\s*(\d+)", ln).group(1)) for ln in lines[:3]]
    assert ns == _reference_sizes(1, cfg)
    assert lines[3].startswith("FedAvg refuses (as it must): FedAvg "
                               "requires homogeneous client models")
    assert lines[4].startswith("DENSE global (wrn16_1) acc: ")
    accs = _accs(lines)
    assert len(accs) == 4 and all(0.0 <= a <= 1.0 for a in accs)
    assert len(lines) == 5


@pytest.mark.parametrize("module", [quickstart, hetero_oneshot])
def test_entry_points_take_only_a_device(module):
    with pytest.raises(SystemExit):
        module.main(["--epochs", "3"])
