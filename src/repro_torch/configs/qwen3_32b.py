"""Qwen3-32B — dense decoder, GQA (64q/8kv), per-head qk RMSNorm; the same
entry, field for field, as the JAX package's ``configs/qwen3_32b.py``.
[hf:Qwen/Qwen3-8B]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    pos_type="rope",
    layer_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    source="hf:Qwen/Qwen3-8B (family card, 32B shape per assignment)",
))
