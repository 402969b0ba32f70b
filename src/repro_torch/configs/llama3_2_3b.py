"""llama3.2-3b [dense] — small llama3. Source: [hf:meta-llama/Llama-3.2-1B]
scaled: 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
(``repro/configs/llama3_2_3b.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-2-3b", family="dense", source="hf:meta-llama/Llama-3.2-1B",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256, rope_theta=500_000.0, max_seq_len=131_072,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, dtype="float32", param_dtype="float32",
        remat=False)
