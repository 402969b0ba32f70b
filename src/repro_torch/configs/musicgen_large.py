"""musicgen-large [audio] — decoder-only LM over EnCodec tokens
(``repro/configs/musicgen_large.py``).

Source: [arXiv:2306.05284]: 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048 (EnCodec codebook). The codec frontend is a stub: the decoder
consumes discrete codec tokens, through the same blocks as the dense
family.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio", source="arXiv:2306.05284",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, max_seq_len=32_768,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=128, dtype="float32", param_dtype="float32", remat=False)
