"""phi3-medium-14b [dense] — RoPE SwiGLU GQA. Source: [arXiv:2404.14219]:
40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
(``repro/configs/phi3_medium_14b.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense", source="arXiv:2404.14219",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
    vocab_size=100352, max_seq_len=131_072,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, dtype="float32", param_dtype="float32", remat=False)
