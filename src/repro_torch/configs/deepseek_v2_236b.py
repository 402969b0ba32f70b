"""deepseek-v2-236b [moe] — MLA (kv_lora 512, q_lora 1536), 2 shared and
160 routed experts top-6 (``repro/configs/deepseek_v2_236b.py``).

Source: [arXiv:2405.04434]: 60L d_model=5120 128H d_ff_expert=1536
vocab=102400, the first layer a dense MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe", source="arXiv:2405.04434",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12288, vocab_size=102400,
    n_experts=160, n_shared_experts=2, top_k=6, d_ff_expert=1536,
    first_dense=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    max_seq_len=131_072,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=192, vocab_size=512, n_experts=4, n_shared_experts=1, top_k=2,
        d_ff_expert=64, kv_lora_rank=32, q_lora_rank=48,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        dtype="float32", param_dtype="float32", remat=False)
