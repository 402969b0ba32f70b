"""Float32 without TF32 at every entry point: each of the five turns TF32
off for matrix products and cuDNN convolutions
(``configs.backend.full_float32``) where it resolves its device, before
any work, when run with ``--device cpu`` (the flags are the same objects
on the card). Each run is stopped at its first piece of work, which
records the flags as it finds them."""
import pytest
import torch

from repro_torch.configs import backend
from repro_torch.launch import (dense_llm_oneshot, hetero_oneshot,
                                quickstart, serve, train)


def _flags() -> dict:
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is None:
        return {"matmul": torch.backends.cuda.matmul.allow_tf32,
                "conv": torch.backends.cudnn.allow_tf32}
    return {"matmul": torch.backends.cuda.matmul.fp32_precision,
            "conv": conv.fp32_precision}


def _tf32_on() -> None:
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is None:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return
    torch.backends.fp32_precision = "tf32"
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    torch.backends.cudnn.fp32_precision = "tf32"
    conv.fp32_precision = "tf32"


OFF = {"matmul": "ieee", "conv": "ieee"} \
    if getattr(torch.backends.cudnn, "conv", None) is not None \
    else {"matmul": False, "conv": False}

# (module, the name its first piece of work is looked up by, argv)
ENTRY_POINTS = {
    "quickstart": (quickstart, "make_classification_data", []),
    "hetero_oneshot": (hetero_oneshot, "make_classification_data", []),
    "train": (train, "get_smoke_config",
              ["--arch", "llama3.2-3b", "--smoke", "--steps", "1"]),
    "dense_llm_oneshot": (dense_llm_oneshot, "CommLedger", ["--smoke"]),
    "serve": (serve, "get_smoke_config", ["--arch", "llama3.2-3b",
                                          "--smoke"])}


class _Stop(Exception):
    pass


@pytest.fixture
def restore_flags():
    yield
    backend.full_float32()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_turns_tf32_off(name, monkeypatch, restore_flags):
    module, first, argv = ENTRY_POINTS[name]
    seen = {}

    def stop(*args, **kwargs):
        seen.update(_flags())
        raise _Stop

    _tf32_on()
    assert _flags() != OFF
    monkeypatch.setattr(module, first, stop)
    with pytest.raises(_Stop):
        module.main([*argv, "--device", "cpu"])
    assert seen == OFF


def test_full_float32_reports_what_it_set(restore_flags):
    _tf32_on()
    got = backend.full_float32()
    assert _flags() == OFF
    assert set(got.values()) <= {"ieee", False}
