"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
Source: [arXiv:2405.21060]: 24L d_model=768 vocab=50280 ssm_state=128,
head_dim=64, expand=2 (d_inner=1536, 24 ssm heads)
(``repro/configs/mamba2_130m.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", source="arXiv:2405.21060",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=1,
    d_ff=0, vocab_size=50280, ssm_state=128, ssm_head_dim=64,
    ssm_expand=2, ssm_chunk=256, ssm_conv=4, ssm_n_groups=1,
    max_seq_len=1_048_576,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, vocab_size=512, ssm_state=16,
        ssm_head_dim=32, ssm_chunk=32,
        dtype="float32", param_dtype="float32", remat=False)
