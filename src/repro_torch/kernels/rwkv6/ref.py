"""Plain PyTorch oracle for the WKV6 recurrence (the naive time scan),
as ``repro.kernels.rwkv6.ref``: what the CUDA kernel is held to on the
card."""
from __future__ import annotations

from repro_torch.models.rwkv import wkv_scan


def wkv6_ref(r, k, v, w, u, state):
    """r,k,v,w: (B,T,H,hd) — w ∈ (0,1); u: (H,hd); state: (B,H,hd,hd) f32.
    Returns (y (B,T,H,hd) f32, new state)."""
    return wkv_scan(r, k, v, w, u, state)
