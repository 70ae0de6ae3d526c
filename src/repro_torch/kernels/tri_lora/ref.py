"""Plain PyTorch versions of the tri-LoRA projection y = x@W + s·x@A@C@B:
the forward and its analytic backward.

:func:`tri_lora_matmul_ref` is ``repro.kernels.tri_lora.ref`` (f32
accumulation, the rank-r intermediate rounded to x's dtype);
:func:`tri_lora_bwd_ref` is the JAX package's five-chain VJP
(``repro.kernels.tri_lora.ops.tri_lora_bwd_ref``: every product
accumulated in f32, each cotangent cast back to its operand's dtype).
The CPU path of :func:`.ops.tri_lora_matmul` and the yardstick the CUDA
kernels are held to; never called on the CUDA path.

The grouped forms (:func:`grouped_tri_lora_matmul_ref`,
:func:`grouped_tri_lora_bwd_ref`) are the same products with one adapter
per group of rows — ``jax.vmap`` of the JAX package's ``dense`` over the
clients, with row i of x2 (M, K) applying group ``groups[i // rows]`` of
the stacked factors and a negative group applying no delta.
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


def _grouped(x2: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
             b: torch.Tensor, groups: torch.Tensor, rows: int) -> tuple:
    """x2 as (E, rows, K) f32, each entry's factors in f32 and the (E,)
    mask of entries that apply a group."""
    sel = groups.long().clamp_min(0)
    return (x2.float().reshape(groups.numel(), rows, -1), a[sel].float(),
            c[sel].float(), b[sel].float(), groups >= 0)


def grouped_tri_lora_matmul_ref(x2: torch.Tensor, w: torch.Tensor,
                                a: torch.Tensor, c: torch.Tensor,
                                b: torch.Tensor, groups: torch.Tensor,
                                rows: int, scaling: float) -> torch.Tensor:
    """x2 (M, K), w (K, N), a (G, K, r), c (G, r, r), b (G, r, N), groups
    (M / rows,) → (M, N) in x2.dtype, the rank-r intermediate of each row
    rounded to x2's dtype as in :func:`tri_lora_matmul_ref`."""
    xs, af, cf, bf, on = _grouped(x2, a, c, b, groups, rows)
    p = (xs @ af) @ cf
    low = scaling * (p.to(x2.dtype).float() @ bf)         # (E, rows, N)
    low = torch.where(on[:, None, None], low, torch.zeros_like(low))
    base = x2.float() @ w.float()
    return (base + low.reshape(base.shape)).to(x2.dtype)


def grouped_tri_lora_bwd_ref(x2: torch.Tensor, w: torch.Tensor,
                             a: torch.Tensor, c: torch.Tensor,
                             b: torch.Tensor, groups: torch.Tensor,
                             g: torch.Tensor, rows: int,
                             scaling: float) -> tuple:
    """(dx, dW, dA, dC, dB) of :func:`grouped_tri_lora_matmul_ref` for the
    cotangent g (M, N): each group's factor grads summed over its rows."""
    xs, af, cf, bf, on = _grouped(x2, a, c, b, groups, rows)
    keep = on.float()[:, None, None]
    gs = g.float().reshape(xs.shape[0], rows, -1)
    gb = (gs @ bf.transpose(1, 2)) * keep                  # (E, rows, r)
    xa = (xs @ af) * keep                                  # (E, rows, r)
    gc = gb @ cf.transpose(1, 2)
    dx = g.float() @ w.float().T + scaling * (
        gc @ af.transpose(1, 2)).reshape(x2.shape)
    dw = x2.float().T @ g.float()

    def per_group(t, like):
        out = torch.zeros(like.shape, dtype=torch.float32, device=t.device)
        out.index_add_(0, groups.long()[on], t[on])
        return out.to(like.dtype)
    da = per_group(scaling * (xs.transpose(1, 2) @ gc), a)
    dc = per_group(scaling * (xa.transpose(1, 2) @ gb), c)
    db = per_group(scaling * ((xa @ cf).transpose(1, 2) @ gs), b)
    return (dx.to(x2.dtype), dw.to(w.dtype), da, dc, db)
