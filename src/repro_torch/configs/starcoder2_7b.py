"""StarCoder2-7B — dense decoder, GQA (36q/4kv), RoPE, LayerNorm + GELU
MLP; the same entry, field for field, as the JAX package's
``configs/starcoder2_7b.py``.  [arXiv:2402.19173]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    attn_bias=True,
    rope_theta=1_000_000.0,
    pos_type="rope",
    layer_pattern=("attn",),
    mlp_type="gelu",
    norm_type="layernorm",
    source="arXiv:2402.19173",
))
