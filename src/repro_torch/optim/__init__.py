from repro_torch.optim.adamw import (Optimizer, adamw,  # noqa: F401
                                    apply_updates, global_norm, sgd)
from repro_torch.optim import schedules  # noqa: F401
