"""qwen1.5-4b [dense] — QKV bias. Source: [hf:Qwen/Qwen1.5-0.5B] scaled:
40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936
(``repro/configs/qwen1_5_4b.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1-5-4b", family="dense", source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab_size=151936, qkv_bias=True, max_seq_len=32_768,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512, dtype="float32", param_dtype="float32", remat=False)
