"""The paper's own evaluation models (shape-faithful backbones).

CE-LoRA evaluates RoBERTa-base (125M), LLaMA-7B, BLIP-2 (3B) and LLaVA-7B.
The decoder backbones are registered with matching shapes, plus a ~100M
decoder used by the end-to-end federated training example — the same
entries, field for field, as the JAX package's ``configs/paper_models.py``.
"""
from repro_torch.models.config import ModelConfig, register

# RoBERTa-base backbone shape (12L, 768, 12H, ff 3072, vocab 50265).
ROBERTA = register(ModelConfig(
    name="celora-roberta-base",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50265,
    pos_type="learned",
    layer_pattern=("attn",),
    mlp_type="gelu",
    norm_type="layernorm",
    lora_targets=("wq", "wv"),
    source="arXiv:1907.11692 (paper model)",
))

# LLaMA-7B shape.
LLAMA7B = register(ModelConfig(
    name="celora-llama-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    rope_theta=10_000.0,
    pos_type="rope",
    layer_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    lora_targets=("wq", "wv"),
    source="arXiv:2302.13971 (paper model)",
))

# ~100M decoder for the end-to-end federated fine-tuning example.
FED100M = register(ModelConfig(
    name="fed-100m",
    family="dense",
    n_layers=8,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=8192,
    rope_theta=10_000.0,
    pos_type="rope",
    layer_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    param_dtype="float32",
    source="this repo (e2e example)",
))
