"""Whisper-small — encoder-decoder transformer backbone, 12+12 layers, MHA
(12q/12kv), learned positions, LayerNorm + GELU; the same entry, field for
field, as the JAX package's ``configs/whisper_small.py``.  The
mel-spectrogram + conv frontend is stubbed: the batch carries precomputed
frame embeddings (B, 1500, d_model).  [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                 # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    pos_type="learned",
    layer_pattern=("attn",),
    mlp_type="gelu",
    norm_type="layernorm",
    enc_dec=True,
    n_enc_layers=12,
    enc_frames=1500,
    max_target_positions=32768,  # honour assigned decode shapes (paper max=448)
    source="arXiv:2212.04356",
))
