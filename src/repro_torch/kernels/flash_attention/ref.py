"""Plain PyTorch flash attention: the forward with its logsumexp, and the
backward as autograd of that forward.

The same math as :func:`repro_torch.models.attention.sdpa` (f32 softmax,
grouped-query, causal rows are the last ``Sq`` of the ``Skv``-long
sequence, a window applies to causal attention only), computed the way the
kernel defines it: ``p = where(valid, exp(s - m), 0)``, ``l = Σ p``,
``out = p·v / max(l, 1e-30)`` and ``lse = m + log(max(l, 1e-30))``.  A row
with no valid key gives out = 0 (``sdpa`` averages v there).  The CPU path
of :func:`.ops.flash_attention` and the tests' yardstick for the CUDA
kernels; never called on the CUDA path.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(sq: int, skv: int, *, causal: bool, window: int,
          device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query row may attend to."""
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        qpos = torch.arange(sq, device=device) + (skv - sq)
        kpos = torch.arange(skv, device=device)
        mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0):
    """q (B,Sq,H,hd), k/v (B,Skv,K,hd), H % K == 0.  Returns (out
    (B,Sq,H,hd) in q.dtype, lse (B,H,Sq) f32); differentiable."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    mask = _mask(sq, skv, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True).detach()     # out does not depend on m
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=q.device))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p / denom, v.float())
    lse = (m + torch.log(denom))[..., 0].reshape(b, h, sq)
    return out.reshape(b, sq, h, hd).to(q.dtype), lse


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Model-layout attention output (B,Sq,H,hd) of the plain forward."""
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window)[0]


def flash_attention_bwd_ref(q, k, v, do, *, causal: bool = True,
                            window: int = 0):
    """(dq, dk, dv) of the plain forward for output cotangent ``do``, by
    autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, do)
