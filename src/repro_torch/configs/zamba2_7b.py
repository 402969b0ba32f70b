"""zamba2-7b [hybrid] — Mamba2 backbone + one shared attention block.
Source: [arXiv:2411.15242]: 81 mamba blocks, d_model=3584, 32H (kv=32),
head_dim 112, d_ff=14336, vocab=32000, ssm_state=64; the shared
(weight-tied) attention+MLP block runs after every 6 mamba blocks: 13
applications, then 3 tail mamba blocks (``repro/configs/zamba2_7b.py``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid", source="arXiv:2411.15242",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, ssm_state=64, ssm_head_dim=64,
    ssm_expand=2, ssm_chunk=256, ssm_conv=4, ssm_n_groups=1,
    attn_every=6, max_seq_len=1_048_576,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=5, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, ssm_state=16, ssm_head_dim=32,
        ssm_chunk=32, attn_every=2,
        dtype="float32", param_dtype="float32", remat=False)
