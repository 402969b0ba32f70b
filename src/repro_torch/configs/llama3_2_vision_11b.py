"""llama-3.2-vision-11b [vlm] — gated cross-attention onto image patches
(``repro/configs/llama3_2_vision_11b.py``).

Source: [hf:meta-llama/Llama-3.2-11B-Vision]: 40L d_model=4096 32H (kv=8)
d_ff=14336 vocab=128256; 8 cross-attention layers, one after every 4
self layers. The vision frontend (a ViT) is a stub: the model takes
projected patch embeddings (n_patches=1601, vision_dim=4096).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-2-vision-11b", family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, rope_theta=500_000.0,
    cross_every=4, n_patches=1601, vision_dim=4096, max_seq_len=131_072,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, cross_every=2, n_patches=17,
        vision_dim=64, dtype="float32", param_dtype="float32", remat=False)
