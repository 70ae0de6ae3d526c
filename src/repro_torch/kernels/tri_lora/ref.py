"""Plain PyTorch versions of the tri-LoRA projection y = x@W + s·x@A@C@B:
the forward and its analytic backward.

:func:`tri_lora_matmul_ref` is ``repro.kernels.tri_lora.ref`` (f32
accumulation, the rank-r intermediate rounded to x's dtype);
:func:`tri_lora_bwd_ref` is the JAX package's five-chain VJP
(``repro.kernels.tri_lora.ops.tri_lora_bwd_ref``: every product
accumulated in f32, each cotangent cast back to its operand's dtype).
The CPU path of :func:`.ops.tri_lora_matmul` and the yardstick the CUDA
kernels are held to; never called on the CUDA path.
"""
from __future__ import annotations

import torch


def tri_lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        c: torch.Tensor, b: torch.Tensor,
                        scaling: float) -> torch.Tensor:
    """x (…, K), w (K, N), a (K, r), c (r, r), b (r, N) → (…, N) in
    x.dtype."""
    base = x.float() @ w.float()
    p = (x.float() @ a.float()) @ c.float()
    low = scaling * (p.to(x.dtype).float() @ b.float())
    return (base + low).to(x.dtype)


def tri_lora_bwd_ref(x2: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                     c: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                     scaling: float) -> tuple:
    """(dx, dW, dA, dC, dB) of y = x2@W + s·x2@A@C@B for the cotangent g
    (M, N) of the flattened x2 (M, K)."""
    gf, xf = g.float(), x2.float()
    af, cf, bf = a.float(), c.float(), b.float()
    gb = gf @ bf.T                          # (M, r)   ∂y/∂(x A C)
    xa = xf @ af                            # (M, r)
    dx = gf @ w.float().T + scaling * ((gb @ cf.T) @ af.T)
    dw = xf.T @ gf
    da = scaling * (xf.T @ (gb @ cf.T))
    dc = scaling * (xa.T @ gb)
    db = scaling * ((xa @ cf).T @ gf)
    return (dx.to(x2.dtype), dw.to(w.dtype), da.to(a.dtype), dc.to(c.dtype),
            db.to(b.dtype))
