from repro_torch.checkpoint.ckpt import (  # noqa: F401
    check_fingerprint, load_subtree, metadata, restore, save, verify)
