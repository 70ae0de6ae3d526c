"""Plain PyTorch versions of the decode kernels: single-token decode
attention over a ring cache, the grouped heterogeneous tri-LoRA GEMV, and
the grouped decode composite.  Same contracts as the JAX package's
``kernels/decode_attention/ref.py``; the CPU path of every wrapper in
:mod:`.ops` and the yardstick each CUDA kernel is held against.  Also the
ragged ring-cache write that the kernel path and the model share."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _row_idx(idx, bsz: int, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int32, device=device).reshape(
        -1).expand(bsz)


def decode_attention_ref(q, k_cache, v_cache, idx):
    """q (B,1,H,hd); k/v_cache (B,R,K,hd); idx: absolute position of the
    NEWEST token already written into the cache — int32 scalar, or (B,) for
    ragged per-row positions (-1 = masked slot; its output row is zero).

    Valid slots: [0, idx] until the ring wraps, then all.  f32 softmax."""
    b, _, h, hd = q.shape
    ring, kh = k_cache.shape[1], k_cache.shape[2]
    idxb = _row_idx(idx, b, q.device)
    slots = torch.arange(ring, device=q.device)
    valid = (slots[None, :] <= idxb[:, None]) | (idxb[:, None] >= ring)
    qg = q.reshape(b, kh, h // kh, hd).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg,
                          k_cache.float()) / math.sqrt(hd)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    out = out.reshape(b, 1, h, hd).to(q.dtype)
    # all-invalid rows would softmax uniformly over -1e30 logits; the kernel
    # contract says masked rows are EXACTLY zero instead
    return torch.where((idxb >= 0)[:, None, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def grouped_gemv_ref(rows, x, w, a, c, b, *, scaling: float = 1.0):
    """Per-row bank gather in plain einsums, f32 throughout.  rows (B,)
    int32 (-1 = masked → exactly zero output row); x (B,K); w (K,N);
    a (m,K,r); c (m,r,r); b (m,r,N) → (B,N) in x.dtype."""
    rows = torch.as_tensor(rows, dtype=torch.int32, device=x.device)
    safe = rows.long().clamp(min=0)
    xf = x.float()
    y = xf @ w.float()
    p = torch.einsum("bk,bkr->br", xf, a[safe].float())
    p = scaling * torch.einsum("br,brs->bs", p, c[safe].float())
    y = y + torch.einsum("bs,bsn->bn", p, b[safe].float())
    return torch.where(rows[:, None] >= 0, y,
                       torch.zeros((), device=y.device)).to(x.dtype)


def ragged_cache_write(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor) -> None:
    """IN PLACE: cache[i, pos[i] % ring] = new[i] for every row with
    pos[i] >= 0; a row with pos -1 keeps its cache unchanged.

    No host sync: a masked row re-writes its own slot-0 entry with the
    value it already holds."""
    bsz, ring = cache.shape[0], cache.shape[1]
    active = pos >= 0
    slot = torch.where(active, torch.remainder(pos, ring),
                       torch.zeros_like(pos)).long()
    rows = torch.arange(bsz, device=cache.device)
    keep = active.reshape((-1,) + (1,) * (new.dim() - 1))
    cache[rows, slot] = torch.where(keep, new.to(cache.dtype),
                                    cache[rows, slot])


def grouped_decode_ref(x, weights, bank, rows, pos, k_cache, v_cache, *,
                       scaling: float = 1.0):
    """Plain composite of the grouped decode step — same signature and
    contract as :func:`..ops.grouped_decode`.  Functional: returns
    (out (B,d), new k_cache, new v_cache) and leaves its inputs alone."""
    bsz = x.shape[0]
    ring, kh, hd = k_cache.shape[1], k_cache.shape[2], k_cache.shape[3]
    h = weights["wq"].shape[1] // hd
    rows = torch.as_tensor(rows, dtype=torch.int32, device=x.device)
    active = rows >= 0
    pos = torch.where(active, torch.as_tensor(pos, dtype=torch.int32,
                                              device=x.device),
                      torch.full_like(rows, -1))

    def gd(xin, name):
        ad = bank[name]
        return grouped_gemv_ref(rows, xin, weights[name], ad["A"], ad["C"],
                                ad["B"], scaling=scaling)

    q = gd(x, "wq").reshape(bsz, 1, h, hd)
    k_new = gd(x, "wk").reshape(bsz, kh, hd)
    v_new = gd(x, "wv").reshape(bsz, kh, hd)
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    ragged_cache_write(k_cache, k_new, pos)
    ragged_cache_write(v_cache, v_new, pos)
    attn = decode_attention_ref(q, k_cache, v_cache, pos)
    out = gd(attn.reshape(bsz, h * hd), "wo")
    return out, k_cache, v_cache
