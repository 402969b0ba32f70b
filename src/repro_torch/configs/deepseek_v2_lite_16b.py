"""deepseek-v2-lite-16b [moe] — MLA (kv_lora 512, no q_lora) and MoE, 64
routed experts top-6 (``repro/configs/deepseek_v2_lite_16b.py``).

Source: [arXiv:2405.04434]: 27L d_model=2048 16H d_ff_expert=1408
vocab=102400, 2 shared experts, the first layer a dense MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe", source="arXiv:2405.04434",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=11264, vocab_size=102400,
    n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
    first_dense=True, kv_lora_rank=512, q_lora_rank=0,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    max_seq_len=131_072,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=192, vocab_size=512, n_experts=4, n_shared_experts=1, top_k=2,
        d_ff_expert=64, kv_lora_rank=32, q_lora_rank=0,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        dtype="float32", param_dtype="float32", remat=False)
