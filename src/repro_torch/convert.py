"""Move parameter, adapter-bank, federated-task and DLG-model trees from
numpy into the port.

The JAX package's trees become numpy trees with
``jax.tree.map(np.asarray, tree)``; these helpers turn such a tree into the
port's tree with the same key paths (dicts stay dicts, tuples stay tuples,
``None`` stays ``None``), and every leaf keeps its dtype: the MoE
block's f32 router beside its bf16 experts and the RG-LRU block's f32
``lam`` cross like any other leaf.  bf16 arrives as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects: it goes
through float32, which holds every bf16 value exactly, and then
``.to(torch.bfloat16)``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.adapter_bank import AdapterBank
from repro_torch.core.fed_model import FedTask
from repro_torch.core.privacy import DLGModel
from repro_torch.core.tri_lora import is_adapter
from repro_torch.tree import tree_leaves, tree_map


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_numpy(tree: Any, device) -> Any:
    """Numpy (or array-like) leaves → tensors on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def bank_from_numpy(tree: dict, *, users: Dict[str, int], device,
                    rank: Optional[int] = None) -> AdapterBank:
    """An :class:`AdapterBank` from a stacked numpy adapter tree (the JAX
    ``AdapterBank.tree`` after ``np.asarray``) and its user → row map."""
    t = params_from_numpy(tree, device)
    ads = [a for a in tree_leaves(t, is_leaf=is_adapter) if is_adapter(a)]
    if not ads:
        raise ValueError("bank tree holds no tri-LoRA {A, B, C} nodes")
    m = int(ads[0]["A"].shape[0])
    r = int(ads[0]["C"].shape[-1]) if rank is None else int(rank)
    return AdapterBank(tree=t, n_clients=m, rank=r, users=dict(users))


def fed_task_from_numpy(cfg, base: dict, n_classes: int, device) -> FedTask:
    """A :class:`FedTask` around a numpy backbone tree (the JAX
    ``FedTask.base`` after ``np.asarray``); ``cfg`` is the port's
    :class:`~repro_torch.models.config.ModelConfig` of the same name."""
    return FedTask(cfg, params_from_numpy(base, device), n_classes)



def dlg_model_from_numpy(arrays: dict, *, device,
                         scaling: float = 2.0) -> DLGModel:
    """A :class:`~repro_torch.core.privacy.DLGModel` from numpy arrays
    ``{'embed', 'w', 'head', 'adapter': {'A', 'C', 'B'}}`` (the JAX
    ``DLGModel``'s fields after ``np.asarray``)."""
    t = params_from_numpy(arrays, device)
    return DLGModel(embed=t["embed"], w=t["w"], head=t["head"],
                    adapter=t["adapter"], scaling=float(scaling))
