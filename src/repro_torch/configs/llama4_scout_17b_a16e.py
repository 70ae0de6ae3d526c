"""Llama-4 Scout 17B-A16E — MoE decoder, 16 experts top-1, GQA (40q/8kv),
early-fusion multimodal (text path here);
the same entry, field for field, as the JAX package's
``configs/llama4_scout_17b_a16e.py``.  [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    pos_type="rope",
    layer_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    n_experts=16,
    top_k=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
