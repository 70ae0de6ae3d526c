"""Architecture registry of the port.

Importing this package registers every ported config; ``--arch <id>``
resolves via ``repro_torch.models.config.get_config``.  Registered so far:
the paper's own models, the dense decoders qwen2.5-14b, qwen3-32b and
starcoder2-7b, the sliding-window decoder h2o-danube-3-4b (``swa``
blocks), and the RWKV-6 family; the other families follow with their
block kinds.
"""
from repro_torch.configs import (  # noqa: F401
    h2o_danube_3_4b,
    paper_models,
    qwen2_5_14b,
    qwen3_32b,
    rwkv6_1_6b,
    starcoder2_7b,
)
