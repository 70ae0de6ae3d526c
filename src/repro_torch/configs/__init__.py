"""Architecture registry of the port.

Importing this package registers every ported config; ``--arch <id>``
resolves via ``repro_torch.models.config.get_config``.  Only the paper's
own models are registered so far; the other families follow with their
block kinds.
"""
from repro_torch.configs import paper_models  # noqa: F401
