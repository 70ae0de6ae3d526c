"""Grok-1 314B — MoE decoder, 8 experts top-2, GQA (48q/8kv);
the same entry, field for field, as the JAX package's
``configs/grok_1_314b.py``.  [hf:xai-org/grok-1]
Gated (GeGLU-style, 3-matrix) experts: 64·8·3·6144·32768 ≈ 310B expert params
+ attention/embeddings ≈ 316B ≈ the advertised 314B — the 2-matrix reading of
d_ff=32768 lands at 213B, so the 3-matrix one is what the card means."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    rope_theta=10_000.0,
    pos_type="rope",
    layer_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    n_experts=8,
    top_k=2,
    source="hf:xai-org/grok-1",
))
