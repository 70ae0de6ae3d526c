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


def apply_tri_lora(x: torch.Tensor, adapter: Adapter,
                   scaling: float) -> torch.Tensor:
    """Low-rank path: scaling · ((x·A)·C)·B, ordered so the intermediate is
    always (..., r)."""
    p = x @ adapter["A"]
    p = p @ adapter["C"]
    return scaling * (p @ adapter["B"])


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
    p = torch.einsum("b...d,bdr->b...r", x, a)
    p = torch.einsum("b...r,brs->b...s", p, c)
    y = scaling * torch.einsum("b...r,brk->b...k", p, b)
    mask = (rows >= 0).reshape((-1,) + (1,) * (y.dim() - 1))
    return torch.where(mask, y, torch.zeros((), dtype=y.dtype, device=y.device))


def merge(w: torch.Tensor, adapter: Adapter, scaling: float) -> torch.Tensor:
    """Inference-time merge (paper eqn. 10): W_i = W + A_i·C_i·B_i."""
    return (w.float() + adapter_delta(adapter, scaling).float()).to(w.dtype)


def is_adapter(node: Any) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {"A", "B", "C"}
