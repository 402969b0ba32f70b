"""Abstract inputs and parameters for every assigned input shape
(``repro/launch/specs.py:19-74``): meta-device tensors of the right
shapes and dtypes, which allocate nothing, the stand-ins a dry run
traces with.

Shapes (the assignment's table):

  train_4k     seq 4096,    global batch 256  -> train step
  prefill_32k  seq 32768,   global batch 32   -> prefill (logits + cache)
  decode_32k   seq 32768,   global batch 128  -> serve step (1 new token)
  long_500k    seq 524288,  global batch 1    -> serve step, the archs
                                                 with a sub-quadratic or
                                                 bounded-state decode only
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T

SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

# the archs with a sub-quadratic or bounded-state decode path
LONG_OK_FAMILIES = ("ssm", "hybrid")
LONG_OK_ARCHS = ("gemma3-4b",)          # sliding-window dense


def long_context_ok(cfg) -> bool:
    return cfg.family in LONG_OK_FAMILIES or cfg.name in LONG_OK_ARCHS


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape_name: str) -> dict:
    """The abstract inputs of (arch, shape): a dict whose structure is
    what the step of that kind takes, with ``kind``, ``batch`` and
    ``seq`` beside them."""
    sh = SHAPES[shape_name]
    B, S, kind = sh["batch"], sh["seq"], sh["kind"]
    out: dict = {"kind": kind, "batch": B, "seq": S}
    vision = _meta((B, cfg.n_patches, cfg.vision_dim),
                   getattr(torch, cfg.dtype)) if cfg.family == "vlm" else None
    if kind == "train":
        out["batch_inputs"] = {"tokens": _meta((B, S), torch.int32),
                               "labels": _meta((B, S), torch.int32)}
        if vision is not None:
            out["batch_inputs"]["vision"] = vision
        return out
    if kind == "prefill":
        out["tokens"] = _meta((B, S), torch.int32)
    else:                   # decode: one new token against a full cache
        out["tokens"] = _meta((B, 1), torch.int32)
        out["pos"] = _meta((), torch.int32)
    out["cache"] = T.init_cache(cfg, B, S, device="meta")
    if vision is not None:
        out["vision"] = vision
    return out


def abstract_params(cfg) -> dict:
    """``init_model``'s tree on the meta device: nothing drawn."""
    return T.init_model(cfg, device="meta")


__all__ = ["LONG_OK_ARCHS", "LONG_OK_FAMILIES", "SHAPES", "abstract_params",
           "input_specs", "long_context_ok"]
