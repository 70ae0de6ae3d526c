"""Blockwise attention with a hand-written backward (the 'blockwise_cv'
attention backend).  PyTorch port of ``repro.models.attention_cv``.

Autograd through :func:`repro_torch.models.attention.blockwise_sdpa` keeps
every tile's intermediates for the backward.  :func:`blockwise_sdpa_cv`
keeps only (q, k, v, out, lse): its backward (Dao et al.'s flash backward)
recomputes each probability tile from them, sums a KV tile's dK / dV over
the q tiles in f32 and stores it in the parameter dtype (bf16 for a bf16
model), and sums dq over the KV tiles in f32 — the JAX package's rounding
points, step for step.  Tiles that the causal band or the window mask out
entirely are skipped (they add exact zeros).  Plain PyTorch on every
device, as the JAX function is plain XLA.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q (B,S,H,hd) → (B,K,G,S,hd); k, v (B,S,K,hd) → (B,K,S,hd)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, hd).permute(0, 2, 3, 1, 4)
    return qg, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


def _tile_live(q0: int, k0: int, bq: int, bk: int, causal: bool,
               window: int) -> bool:
    """Whether the (bq, bk) tile at rows q0…, keys k0… holds an unmasked
    entry."""
    if not causal:
        return True
    if k0 > q0 + bq - 1:                         # above the diagonal
        return False
    return not (window and k0 + bk - 1 <= q0 - window)   # below the band


def _mask(q0: int, k0: int, bq: int, bk: int, causal: bool, window: int,
          device) -> torch.Tensor:
    qpos = torch.arange(q0, q0 + bq, device=device)
    kpos = torch.arange(k0, k0 + bk, device=device)
    mask = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _fwd_stats(q, k, v, causal: bool, window: int, bq: int, bk: int):
    """The blockwise forward: (out (B,S,H,hd) in q's dtype, lse (B,K,G,S)
    f32), lse = m + log l per row."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg, kt, vt = _layout(q, k, v)
    dev = q.device
    outs, lses = [], []
    for q0 in range(0, sq, bq):
        qc = qg[:, :, :, q0:q0 + bq].float() * scale
        g = qc.shape[2]
        m_run = torch.full((b, kh, g, bq), NEG_INF, device=dev)
        l_run = torch.zeros((b, kh, g, bq), device=dev)
        acc = torch.zeros((b, kh, g, bq, hd), device=dev)
        for k0 in range(0, skv, bk):
            if not _tile_live(q0, k0, bq, bk, causal, window):
                continue
            mask = _mask(q0, k0, bq, bk, causal, window, dev)
            s = torch.einsum("bkgqd,bksd->bkgqs", qc,
                             kt[:, :, k0:k0 + bk].float())
            s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            torch.zeros((), device=dev))
            l_run = alpha * l_run + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p, vt[:, :, k0:k0 + bk].float())
            m_run = m_new
        l_safe = l_run.clamp_min(1e-30)
        outs.append(acc / l_safe[..., None])
        lses.append(m_run + torch.log(l_safe))
    o = torch.cat(outs, dim=3)                               # (B,K,G,S,hd)
    out = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
    return out, torch.cat(lses, dim=3)


def _cv_bwd(q, k, v, out, lse, dout, causal: bool, window: int, bq: int,
            bk: int):
    """dq, dk, dv from the saved (q, k, v, out, lse): per KV tile, the q
    tiles' dK / dV summed in f32 and stored in k's / v's dtype; dq summed
    over the KV tiles in f32, returned in q's dtype."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg, kt, vt = _layout(q, k, v)
    og = _layout(out, k, v)[0].float()
    dog = _layout(dout, k, v)[0].float()
    d_row = (dog * og).sum(-1)                               # (B,K,G,S)
    dq_acc = torch.zeros((b, kh, g, sq, hd), device=dev)
    dk = torch.empty((b, kh, skv, hd), dtype=k.dtype, device=dev)
    dv = torch.empty((b, kh, skv, hd), dtype=v.dtype, device=dev)
    for k0 in range(0, skv, bk):
        kc = kt[:, :, k0:k0 + bk].float()
        vc = vt[:, :, k0:k0 + bk].float()
        dk_t = torch.zeros((b, kh, bk, hd), device=dev)
        dv_t = torch.zeros((b, kh, bk, hd), device=dev)
        for q0 in range(0, sq, bq):
            if not _tile_live(q0, k0, bq, bk, causal, window):
                continue
            mask = _mask(q0, k0, bq, bk, causal, window, dev)
            qc = qg[:, :, :, q0:q0 + bq].float() * scale
            do_c = dog[:, :, :, q0:q0 + bq]
            s = torch.einsum("bkgqd,bksd->bkgqs", qc, kc)
            p = torch.where(mask, torch.exp(s - lse[..., q0:q0 + bq, None]),
                            torch.zeros((), device=dev))
            dv_t += torch.einsum("bkgqs,bkgqd->bksd", p, do_c)
            dp = torch.einsum("bkgqd,bksd->bkgqs", do_c, vc)
            ds = p * (dp - d_row[..., q0:q0 + bq, None])
            dq_acc[:, :, :, q0:q0 + bq] += torch.einsum(
                "bkgqs,bksd->bkgqd", ds, kc) * scale
            dk_t += torch.einsum("bkgqs,bkgqd->bksd", ds, qc)
        dk[:, :, k0:k0 + bk] = dk_t.to(k.dtype)
        dv[:, :, k0:k0 + bk] = dv_t.to(v.dtype)
    dq = dq_acc.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
    return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


class _BlockwiseCV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, bq, bk):
        out, lse = _fwd_stats(q, k, v, causal, window, bq, bk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, bq, bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _cv_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def blockwise_sdpa_cv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0, bq: int = 256,
                      bk: int = 256) -> torch.Tensor:
    """Attention of q (B,Sq,H,hd) over k, v (B,Skv,K,hd), H % K == 0,
    causal with ``window`` (0: the whole prefix; query i at key position
    i) or bidirectional; Sq a multiple of ``bq``, Skv of ``bk``.  Returns
    (B,Sq,H,hd) in q's dtype; differentiable in q, k and v through the
    hand-written backward."""
    sq, skv = q.shape[1], k.shape[1]
    if sq % bq or skv % bk:
        raise ValueError(f"blockwise_sdpa_cv needs Sq, Skv multiples of the "
                         f"tiles; got Sq={sq}, Skv={skv}, bq={bq}, bk={bk}")
    return _BlockwiseCV.apply(q, k, v, bool(causal), int(window), int(bq),
                              int(bk))
