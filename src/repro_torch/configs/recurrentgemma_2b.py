"""RecurrentGemma-2B (Griffin) — hybrid: RG-LRU recurrent blocks + local
sliding-window attention in a 2:1 pattern, GQA (10q/1kv);
the same entry, field for field, as the JAX package's
``configs/recurrentgemma_2b.py``.  [arXiv:2402.19427]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    rope_theta=10_000.0,
    pos_type="rope",
    local_window=2048,
    layer_pattern=("rglru", "rglru", "swa"),
    window=2048,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rnn_width=2560,
    conv1d_width=4,
    source="arXiv:2402.19427",
))
