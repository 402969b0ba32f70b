"""Architecture configurations of the LMs the port serves and trains
(``repro/configs/base.py``).

``ArchConfig`` copies the reference's fields under the same names and
defaults (all but ``scan_layers``: the port loops over its layers, so
the reference's unrolled dry-run variant has no counterpart);
``head_dim`` is derived from ``d_model // n_heads`` when left at 0. A
hybrid's ``n_layers`` counts its mamba blocks: zamba2-7b's 81 are 13
super-blocks of ``attn_every`` = 6 and a tail of 3, with the shared
attention block applied after each super-block (13 times), as
``repro/models/transformer.py:119`` runs it (the reference's comment at
``base.py:64-65`` says otherwise). A vlm's ``n_layers`` counts its self-
and cross-attention layers together: ``cross_every`` self layers, then
one cross layer, a super-block. ``param_count`` and
``active_param_count`` are the reference's analytic counts. Each
architecture the reference registers has a module here exporting
``CONFIG`` (the published shape) and ``smoke()`` (a reduced variant for
CPU tests), as in the reference.
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
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = True
    max_seq_len: int = 131_072

    # sliding-window pattern (gemma3): the window of the local layers;
    # every ``global_every``-th layer is global (0: every layer local)
    sliding_window: int = 0
    global_every: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense: bool = False       # deepseek: layer 0 has a dense MLP
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0           # 0 -> standard GQA path
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

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

    # VLM (llama-3.2-vision): a gated cross-attention layer after every
    # ``cross_every`` self layers, onto stubbed patch embeddings
    # (n_patches, vision_dim)
    cross_every: int = 0
    n_patches: int = 0
    vision_dim: int = 0

    # audio (musicgen): a decoder over codec tokens, the frontend stubbed
    audio_frontend: bool = False

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
    def attention_kind(self) -> str:
        return "mla" if self.kv_lora_rank else "gqa"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (``repro/configs/base.py:128-162``)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            return emb + L * _mamba2_params(self)
        if self.family == "hybrid":
            n_shared_apps = L // (self.attn_every + 1)
            n_ssm = L - n_shared_apps
            shared = _attn_params(self) + 3 * d * self.d_ff
            return emb + n_ssm * _mamba2_params(self) + shared
        attn = _attn_params(self)
        if self.n_experts:
            mlp = (self.n_experts + self.n_shared_experts) * 3 * d \
                * self.d_ff_expert + d * self.n_experts
            if self.first_dense:
                dense_mlp = 3 * d * (self.d_ff_expert
                                     * (self.top_k + self.n_shared_experts))
                return emb + attn * L + mlp * (L - 1) + dense_mlp
        else:
            mlp = 3 * d * self.d_ff
        total = emb + L * (attn + mlp)
        if self.cross_every:
            total += L // (self.cross_every + 1) * _attn_params(self)
        return total

    def active_param_count(self) -> int:
        """Parameters a token reads (MoE: the routed top-k and the shared
        experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        mlp_active = (self.top_k + self.n_shared_experts) * 3 * d \
            * self.d_ff_expert + d * self.n_experts
        return self.vocab_size * d + L * (_attn_params(self) + mlp_active)


def _attn_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    if cfg.kv_lora_rank:
        qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        q = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qd) \
            if cfg.q_lora_rank else d * cfg.n_heads * qd
        kv = d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) \
            + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_head_dim
                                                + cfg.v_head_dim)
        return q + kv + cfg.n_heads * cfg.v_head_dim * d
    hd = cfg.head_dim
    return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d


def _mamba2_params(cfg: ArchConfig) -> int:
    d, di, g, n = cfg.d_model, cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state
    h = cfg.n_ssm_heads
    in_proj = d * (2 * di + 2 * g * n + h)
    conv = cfg.ssm_conv * (di + 2 * g * n)
    return in_proj + conv + di * d + 2 * h + di  # A, D, norm


# architecture id -> module of the port: every architecture the reference
# registers (``repro/configs/base.py:208-212``)
_PORTED = {"llama3-2-3b": "repro_torch.configs.llama3_2_3b",
           "qwen1-5-4b": "repro_torch.configs.qwen1_5_4b",
           "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
           "musicgen-large": "repro_torch.configs.musicgen_large",
           "mamba2-130m": "repro_torch.configs.mamba2_130m",
           "zamba2-7b": "repro_torch.configs.zamba2_7b",
           "gemma3-4b": "repro_torch.configs.gemma3_4b",
           "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
           "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
           "llama3-2-vision-11b": "repro_torch.configs.llama3_2_vision_11b"}
_ALIASES = {"qwen1.5-4b": "qwen1-5-4b", "llama3.2-3b": "llama3-2-3b",
            "llama-3.2-vision-11b": "llama3-2-vision-11b",
            "llama3.2-vision-11b": "llama3-2-vision-11b"}


def available_archs() -> list[str]:
    return sorted(_PORTED)


def _module(name: str):
    key = name.replace("_", "-")
    key = _ALIASES.get(key, key)
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
