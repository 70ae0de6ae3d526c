"""Qwen2-VL-72B — VLM decoder backbone, GQA (64q/8kv), QKV bias, M-RoPE
(t/h/w position triplets); the same entry, field for field, as the JAX
package's ``configs/qwen2_vl_72b.py``.  The ViT vision encoder + projector
is stubbed: the batch carries precomputed patch embeddings.
[arXiv:2409.12191]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1_000_000.0,
    pos_type="mrope",
    mrope_sections=(16, 24, 24),
    layer_pattern=("attn",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    vision_patches=256,
    source="arXiv:2409.12191",
))
