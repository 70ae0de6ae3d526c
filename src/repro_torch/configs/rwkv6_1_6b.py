"""RWKV-6 "Finch" 1.6B — attention-free SSM with data-dependent decay,
24 layers, d_model 2048 (head dim 64), channel-mix d_ff 7168; the same
entry, field for field, as the JAX package's ``configs/rwkv6_1_6b.py``.
[arXiv:2404.05892]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                  # 2048 / 64
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    pos_type="none",
    layer_pattern=("rwkv6",),
    norm_type="layernorm",
    source="arXiv:2404.05892",
))
