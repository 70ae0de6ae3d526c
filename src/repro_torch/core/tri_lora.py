"""Tri-matrix LoRA factorization — the paper's §III-B contribution.

Vanilla LoRA:      h = x·W + x·A·B            (A: d×r, B: r×k)
CE-LoRA (tri):     h = x·W + x·A·C·B          (C: r×r, full-rank core)

Only ``C`` is transmitted between clients and server during federated
fine-tuning; ``A`` and ``B`` remain local.

Initialization: ``A ~ N(0, 1/r)``, ``B = 0``, ``C = I_r`` — the adapter
starts at ΔW = 0.  PyTorch port of ``repro.core.tri_lora`` (plain tensor
functions over {'A','C','B'} dicts).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.tree import tree_leaves, tree_map

Adapter = Dict[str, torch.Tensor]  # {'A': (d,r), 'C': (r,r), 'B': (r,k)}


def init_adapter(generator: torch.Generator, d_in: int, d_out: int, rank: int,
                 dtype: torch.dtype = torch.float32) -> Adapter:
    """One tri-LoRA adapter for a (d_in, d_out) projection, drawn on the
    generator's device."""
    dev = generator.device
    a = torch.randn((d_in, rank), generator=generator, device=dev,
                    dtype=torch.float32) / math.sqrt(rank)
    return {"A": a.to(dtype),
            "C": torch.eye(rank, dtype=dtype, device=dev),
            "B": torch.zeros((rank, d_out), dtype=dtype, device=dev)}


def adapter_delta(adapter: Adapter, scaling: float) -> torch.Tensor:
    """Materialize ΔW = scaling · A·C·B (used for merge at inference)."""
    acb = adapter["A"] @ adapter["C"] @ adapter["B"]
    return (scaling * acb.float()).to(adapter["A"].dtype)


def _promoted(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Both operands in their promoted type, as ``jnp`` promotes a product
    of a bf16 activation and an f32 adapter factor to f32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def apply_tri_lora(x: torch.Tensor, adapter: Adapter,
                   scaling: float) -> torch.Tensor:
    """Low-rank path: scaling · ((x·A)·C)·B, ordered so the intermediate is
    always (..., r); computed in the promoted type of x and the factors."""
    p = torch.matmul(*_promoted(x, adapter["A"]))
    p = torch.matmul(*_promoted(p, adapter["C"]))
    return scaling * torch.matmul(*_promoted(p, adapter["B"]))


def apply_tri_lora_grouped(x: torch.Tensor, bank: Adapter, scaling: float,
                           rows: torch.Tensor) -> torch.Tensor:
    """Heterogeneous-batch low-rank path: row ``i`` of the batch applies
    adapter ``rows[i]`` from a stacked (m, …) bank.

    x (B, …, d); bank {'A': (m,d,r), 'C': (m,r,r), 'B': (m,r,k)}; rows (B,)
    int32 — masked slots (rows < 0) read bank row 0 through a clamped index
    but contribute an exactly-zero delta.
    """
    safe = rows.long().clamp(min=0)
    a, c, b = bank["A"][safe], bank["C"][safe], bank["B"][safe]
    p = torch.einsum("b...d,bdr->b...r", *_promoted(x, a))
    p = torch.einsum("b...r,brs->b...s", *_promoted(p, c))
    y = scaling * torch.einsum("b...r,brk->b...k", *_promoted(p, b))
    mask = (rows >= 0).reshape((-1,) + (1,) * (y.dim() - 1))
    return torch.where(mask, y, torch.zeros((), dtype=y.dtype, device=y.device))


def merge(w: torch.Tensor, adapter: Adapter, scaling: float) -> torch.Tensor:
    """Inference-time merge (paper eqn. 10): W_i = W + A_i·C_i·B_i."""
    return (w.float() + adapter_delta(adapter, scaling).float()).to(w.dtype)


def comm_payload(adapter: Adapter) -> torch.Tensor:
    """What CE-LoRA sends over the wire each round: C only."""
    return adapter["C"]


def load_payload(adapter: Adapter, c_bar: torch.Tensor) -> Adapter:
    """Install the server's personalized aggregate C̄_i (paper §III-D)."""
    return {**adapter, "C": c_bar.to(adapter["C"].dtype)}


# ---------------------------------------------------------------------------
# Tree-level helpers: an "adapter tree" is any tree whose leaves are adapter
# dicts (recognized by their {'A','B','C'} keys).
# ---------------------------------------------------------------------------

def is_adapter(node: Any) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {"A", "B", "C"}


def adapters_of(adapter_tree: Any) -> list:
    """The adapter dicts of a tree, in tree order."""
    return [a for a in tree_leaves(adapter_tree, is_leaf=is_adapter)
            if is_adapter(a)]


def tree_payload(adapter_tree: Any) -> Any:
    """Extract the C-matrix tree (the full federated payload)."""
    return tree_map(comm_payload, adapter_tree, is_leaf=is_adapter)


def tree_load_payload(adapter_tree: Any, c_tree: Any) -> Any:
    """Install one C per adapter; ``c_tree`` has the structure of
    :func:`tree_payload`'s result."""
    return tree_map(lambda a, c: load_payload(a, c), adapter_tree, c_tree,
                    is_leaf=is_adapter)


def payload_num_params(adapter_tree: Any) -> int:
    """Floats transmitted per round by CE-LoRA (Σ r² over adapted modules)."""
    return sum(a["C"].numel() for a in adapters_of(adapter_tree))


def combine_adapters(a1: Adapter, a2: Adapter) -> Adapter:
    """Express the SUM of two tri-LoRA adapters as one rank-(r1+r2) adapter:
    A = [A1 A2], C = blockdiag(C1, C2), B = [B1; B2].  Used by the FDLoRA
    baseline (dual global+local LoRA modules) so the model forward stays
    single-adapter."""
    c1, c2 = a1["C"], a2["C"]
    r1, r2 = c1.shape[-1], c2.shape[-1]
    lead = tuple(c1.shape[:-2])
    z12 = c1.new_zeros(lead + (r1, r2))
    z21 = c1.new_zeros(lead + (r2, r1))
    top = torch.cat([c1, z12], dim=-1)
    bot = torch.cat([z21, c2.to(c1.dtype)], dim=-1)
    return {"A": torch.cat([a1["A"], a2["A"]], dim=-1),
            "C": torch.cat([top, bot], dim=-2),
            "B": torch.cat([a1["B"], a2["B"]], dim=-2)}


def tree_combine(t1: Any, t2: Any) -> Any:
    return tree_map(combine_adapters, t1, t2, is_leaf=is_adapter)


def full_lora_num_params(adapter_tree: Any) -> int:
    """Floats FedPETuning would transmit (A and B)."""
    return sum(a["A"].numel() + a["B"].numel()
               for a in adapters_of(adapter_tree))
