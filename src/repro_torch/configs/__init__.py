"""Architecture registry of the port.

Importing this package registers every config; ``--arch <id>`` resolves via
``repro_torch.models.config.get_config``.  Registered: the paper's own
models and every assigned architecture (``ASSIGNED``, the JAX package's
list): the dense decoders qwen2.5-14b, qwen3-32b and starcoder2-7b, the
sliding-window decoder h2o-danube-3-4b (``swa`` blocks), the RWKV-6
family, the MoE decoders grok-1-314b and llama4-scout-17b-a16e, the RG-LRU
hybrid recurrentgemma-2b, the encoder-decoder whisper-small and the VLM
qwen2-vl-72b (M-RoPE).
"""
from repro_torch.configs import (  # noqa: F401
    grok_1_314b,
    h2o_danube_3_4b,
    llama4_scout_17b_a16e,
    paper_models,
    qwen2_5_14b,
    qwen2_vl_72b,
    qwen3_32b,
    recurrentgemma_2b,
    rwkv6_1_6b,
    starcoder2_7b,
    whisper_small,
)

ASSIGNED = (
    "qwen2.5-14b",
    "qwen3-32b",
    "grok-1-314b",
    "starcoder2-7b",
    "llama4-scout-17b-a16e",
    "h2o-danube-3-4b",
    "whisper-small",
    "rwkv6-1.6b",
    "qwen2-vl-72b",
    "recurrentgemma-2b",
)
