"""Qwen2.5-14B — dense decoder, GQA (40q/8kv), QKV bias; the same entry,
field for field, as the JAX package's ``configs/qwen2_5_14b.py``.
[hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1_000_000.0,
    pos_type="rope",
    layer_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    source="hf:Qwen/Qwen2.5-0.5B (family card, 14B shape per assignment)",
))
