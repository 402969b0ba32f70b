"""gemma3-4b [dense] — 5:1 local:global sliding-window attention, 128k
context (``repro/configs/gemma3_4b.py``).

Source: [hf:google/gemma-3-1b-pt] scaled per assignment: 34L
d_model=2560 8H (GQA kv=4, head_dim 256) d_ff=10240 vocab=262144; every
sixth layer global, the others a 1024-token window.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense", source="hf:google/gemma-3-1b-pt",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144, rope_theta=1_000_000.0,
    sliding_window=1024, global_every=6, max_seq_len=131_072,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, sliding_window=8, global_every=2,
        dtype="float32", param_dtype="float32", remat=False)
