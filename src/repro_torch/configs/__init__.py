"""Architecture registry of the port.

Importing this package registers every ported config; ``--arch <id>``
resolves via ``repro_torch.models.config.get_config``.  Registered so far:
the paper's own models and the RWKV-6 family; the other families follow
with their block kinds.
"""
from repro_torch.configs import paper_models, rwkv6_1_6b  # noqa: F401
