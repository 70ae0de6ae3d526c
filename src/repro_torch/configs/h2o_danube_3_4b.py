"""H2O-Danube3-4B — dense decoder (llama+mistral mix), GQA (32q/8kv),
sliding-window attention; the same entry, field for field, as the JAX
package's ``configs/h2o_danube_3_4b.py``.  [arXiv:2401.16818]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    rope_theta=10_000.0,
    pos_type="rope",
    window=4096,
    layer_pattern=("swa",),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    source="arXiv:2401.16818",
))
