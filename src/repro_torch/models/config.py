"""Model configuration system (PyTorch port of ``repro.models.config``).

Every architecture is a :class:`ModelConfig` — a frozen, hashable
dataclass with the same fields, defaults and registry as the JAX package's,
so a config name resolves to the same shapes in both packages.

The layer stack is described by ``layer_pattern``: a repeating tuple of block
kinds.  ``n_layers = q * len(pattern) + rem`` — the stack is ``q``
repetitions of the pattern (parameters stacked on a leading group axis)
followed by ``rem`` leading-pattern layers.  Kinds:

- ``attn``   : full-attention block (+ dense or MoE MLP)
- ``swa``    : sliding-window attention block (``window`` controls size)
- ``rwkv6``  : RWKV-6 "Finch" time-mix + channel-mix (attention-free)
- ``rglru``  : RG-LRU recurrent block (RecurrentGemma)

An ``attn`` block also carries cross-attention in an encoder-decoder
config (``enc_dec``), whose encoder is a stack of bidirectional ``attn``
blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

BlockKind = str  # attn | swa | rwkv6 | rglru


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    source: str = ""                  # citation for the config

    # --- attention details -------------------------------------------------
    attn_bias: bool = False           # bias on q,k,v projections (qwen2.5)
    qk_norm: bool = False             # per-head RMSNorm on q,k (qwen3)
    rope_theta: float = 1e4
    pos_type: str = "rope"            # rope | mrope | learned | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # qwen2-vl split of hd/2
    window: int = 0                   # sliding-window size for `swa` blocks
    local_window: int = 2048          # window for hybrid local-attn blocks
    layer_pattern: Tuple[BlockKind, ...] = ("attn",)
    attn_impl: str = "auto"           # attention backend name

    # --- MLP / norm --------------------------------------------------------
    mlp_type: str = "swiglu"          # swiglu | gelu
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0                # 0 -> dense MLP
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- recurrent (rwkv6 / rglru) ----------------------------------------
    rnn_width: int = 0                # 0 -> d_model
    conv1d_width: int = 4             # RG-LRU temporal conv width

    # --- encoder-decoder (whisper) -----------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500            # stub frontend output length
    max_target_positions: int = 4096  # learned-pos table size

    # --- multimodal stubs --------------------------------------------------
    vision_patches: int = 0           # VLM: # of precomputed patch embeddings

    # --- tri-LoRA ----------------------------------------------------------
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")
    lora_mlp: bool = False            # also adapt MLP in/out projections

    # --- numerics ----------------------------------------------------------
    param_dtype: str = "bfloat16"
    remat: bool = True

    # ------------------------------------------------------------------ api
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (the JAX package's shardable layout);
        pad logits are masked to -1e30, so semantics are exact."""
        return -(-self.vocab_size // 256) * 256

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def rnn_d(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def stack_plan(self) -> tuple[int, tuple[BlockKind, ...], tuple[BlockKind, ...]]:
        """Return (n_groups, pattern, remainder_kinds)."""
        p = len(self.layer_pattern)
        q, rem = divmod(self.n_layers, p)
        return q, self.layer_pattern, self.layer_pattern[:rem]

    def kinds(self) -> tuple[BlockKind, ...]:
        """Flat per-layer kind list (length n_layers)."""
        q, pat, rem = self.stack_plan()
        return pat * q + rem

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **kw) -> "ModelConfig":
        """Smoke-test variant of the same family: tiny but structurally equal."""
        pat = self.layer_pattern
        base = dict(
            n_layers=max(2, len(pat)),
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=64,
            d_ff=512,
            vocab_size=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_enc_layers=2 if self.enc_dec else 0,
            enc_frames=16 if self.enc_dec else self.enc_frames,
            vision_patches=16 if self.vision_patches else 0,
            window=min(self.window, 64) if self.window else 0,
            local_window=64,
            rnn_width=256 if self.rnn_width or self.family in ("ssm", "hybrid") else 0,
            max_target_positions=256,
            lora_rank=4,
            param_dtype="float32",
            name=self.name + "-reduced",
        )
        if self.pos_type == "mrope":
            half = base["head_dim"] // 2
            hw = 3 * half // 8
            base["mrope_sections"] = (half - 2 * hw, hw, hw)
        base.update(kw)
        return dataclasses.replace(self, **base)


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # importing repro_torch.configs populates the registry
    import repro_torch.configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
