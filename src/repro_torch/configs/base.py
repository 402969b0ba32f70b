"""Architecture configurations of the LMs the port serves and trains
(``repro/configs/base.py``).

``ArchConfig`` copies the reference's fields that the dense, audio
(attention), ssm (Mamba-2) and hybrid (Zamba2) families read, under the
same names and defaults; ``head_dim`` is derived from ``d_model //
n_heads`` when left at 0. A hybrid's ``n_layers`` counts its mamba
blocks: zamba2-7b's 81 are 13 super-blocks of ``attn_every`` = 6 and a
tail of 3, with the shared attention block applied after each
super-block (13 times), as ``repro/models/transformer.py:119`` runs it
(the reference's comment at ``base.py:64-65`` says otherwise). Each ported architecture has
a module exporting ``CONFIG`` (the published shape) and ``smoke()`` (a
reduced variant for CPU tests), as in the reference.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str = "unnamed"
    family: str = "dense"
    source: str = ""

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    max_seq_len: int = 131_072
    sliding_window: int = 0

    # SSM (mamba2)
    ssm_state: int = 0              # N; 0 -> no ssm
    ssm_head_dim: int = 64          # P
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_n_groups: int = 1
    # hybrid (zamba2): one shared attention block after every
    # ``attn_every`` mamba blocks
    attn_every: int = 0

    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True              # recompute each layer in the backward
    use_blockwise_attn: bool = True
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    # "ref" (plain PyTorch), "autodiff" or "fused" (the kernels); None
    # defers to the device's profile (configs/backend.py)
    kernel_vjp_mode: str | None = None

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# architecture id -> module of the port; the reference's other
# architectures, and the slice of ROADMAP.md that brings each
_PORTED = {"llama3-2-3b": "repro_torch.configs.llama3_2_3b",
           "qwen1-5-4b": "repro_torch.configs.qwen1_5_4b",
           "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
           "musicgen-large": "repro_torch.configs.musicgen_large",
           "mamba2-130m": "repro_torch.configs.mamba2_130m",
           "zamba2-7b": "repro_torch.configs.zamba2_7b"}
_NOT_YET = {
    "gemma3-4b": "the dense-mode-only families (sliding window)",
    "deepseek-v2-236b": "the dense-mode-only families (moe, MLA)",
    "deepseek-v2-lite-16b": "the dense-mode-only families (moe, MLA)",
    "llama3-2-vision-11b": "the dense-mode-only families (vlm)",
}
_ALIASES = {"qwen1.5-4b": "qwen1-5-4b", "llama3.2-3b": "llama3-2-3b",
            "llama-3.2-vision-11b": "llama3-2-vision-11b",
            "llama3.2-vision-11b": "llama3-2-vision-11b"}


def available_archs() -> list[str]:
    return sorted(_PORTED)


def _module(name: str):
    key = name.replace("_", "-")
    key = _ALIASES.get(key, key)
    if key in _NOT_YET:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; it comes with "
            f"{_NOT_YET[key]} (ROADMAP.md)")
    if key not in _PORTED:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{available_archs()}")
    return importlib.import_module(_PORTED[key])


def get_config(name: str) -> ArchConfig:
    """Look up a ported architecture by id, e.g. ``llama3.2-3b``."""
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    """Reduced same-family variant for CPU tests."""
    return _module(name).smoke()
