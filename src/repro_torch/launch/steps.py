"""Prefill and decode steps against a dense cache
(``repro/launch/steps.py:69,84``): the serving engine's dense mode, the
sequential oracle its paged mode is held to."""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T


def make_prefill_step(cfg):
    def prefill_step(params, cache, tokens):
        """tokens: (B, S) from position 0 into ``cache``; returns the last
        position's logits (B, 1, V) and the filled cache."""
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        logits, cache = T.forward(params, cfg, tokens=tokens,
                                  positions=positions, cache=cache,
                                  cache_pos=0)
        return logits[:, -1:], cache

    return prefill_step


def make_serve_step(cfg):
    """One decode step: a single new token against a pre-filled cache."""
    def serve_step(params, cache, tokens, pos: int):
        positions = torch.tensor([pos], dtype=torch.int32,
                                 device=tokens.device)
        return T.forward(params, cfg, tokens=tokens, positions=positions,
                         cache=cache, cache_pos=pos)

    return serve_step
