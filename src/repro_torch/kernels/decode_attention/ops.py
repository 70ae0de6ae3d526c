"""Wrappers of the decode kernels: ragged decode attention over a ring
cache, the grouped heterogeneous tri-LoRA dense, and the grouped decode
composite built from them.

Each wrapper takes its plain version (:mod:`.ref`) when the tensors lie on
the CPU.  On a CUDA tensor it launches its hand-written kernel
(``csrc/*.cu``, built by :mod:`repro_torch.kernels.build`) or raises: it
checks device, dtype, shape and contiguity first, and raises when the
launch reports an error.  ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ffi
from repro_torch.kernels.decode_attention import ref

#: Kernel launches per wrapper; incremented only where a kernel is launched.
LAUNCHES = {"decode_attention": 0, "grouped_gemv": 0}

_ATTN_HEAD_DIMS = (64, 128)
GEMV_MAX_RANK = 32

_VP, _I, _LL, _F = ffi.VP, ffi.I, ffi.LL, ffi.F


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, idx) -> torch.Tensor:
    """q (B,1,H,hd); k/v_cache (B,R,K,hd); idx () or (B,) int32 — the newest
    written position per row (-1 = masked slot, output row exactly zero).
    Slots ``s <= idx`` are valid until the ring wraps (``idx >= R``), then
    all are.  → (B,1,H,hd) in q.dtype."""
    idx = torch.as_tensor(idx, dtype=torch.int32, device=q.device)
    if not ffi.on_cuda(q, k_cache, v_cache, idx):
        return ref.decode_attention_ref(q, k_cache, v_cache, idx)
    b, one, h, hd = q.shape
    ffi.require(one == 1,
                f"decode attention takes one query token, got {one}")
    ffi.require(k_cache.dim() == 4 and k_cache.shape == v_cache.shape
                and k_cache.shape[0] == b and k_cache.shape[3] == hd,
                f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
                f"do not match q {tuple(q.shape)}")
    ring, kh = k_cache.shape[1], k_cache.shape[2]
    ffi.require(kh >= 1 and h % kh == 0,
                f"{h} query heads over {kh} KV heads")
    ffi.require(hd in _ATTN_HEAD_DIMS,
                f"head_dim {hd} not in {_ATTN_HEAD_DIMS}")
    ffi.require(q.dtype in ffi.DTYPE_CODE and k_cache.dtype == q.dtype
                and v_cache.dtype == q.dtype,
                f"dtypes q={q.dtype} k={k_cache.dtype} v={v_cache.dtype}; the "
                f"kernel takes one of {list(ffi.DTYPE_CODE)} for all three")
    ffi.require(q.is_contiguous(), "q must be contiguous")
    ffi.require(k_cache.stride(3) == 1 and v_cache.stride(3) == 1,
                "cache channels must be contiguous (unit stride)")
    ffi.require(idx.dim() == 0 or tuple(idx.shape) == (b,),
                f"idx shape {tuple(idx.shape)} is neither () nor ({b},)")
    idx = idx.contiguous()
    out = torch.empty_like(q)
    fn = ffi.fn("decode_attention", "decode_attention_launch",
                [_I, _I, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _I, _I,
                 _LL, _LL, _LL, _LL, _LL, _LL, _F, _VP])
    code = fn(ffi.DTYPE_CODE[q.dtype], hd, q.data_ptr(), k_cache.data_ptr(),
              v_cache.data_ptr(), idx.data_ptr(), 0 if idx.dim() == 0 else 1,
              out.data_ptr(), b, h, kh, ring, *k_cache.stride()[:3],
              *v_cache.stride()[:3], float(hd) ** -0.5, ffi.stream())
    ffi.check("decode_attention", code)
    LAUNCHES["decode_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# grouped tri-LoRA dense
# ---------------------------------------------------------------------------

def grouped_dense(rows, x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                  c: torch.Tensor, b: torch.Tensor, *,
                  scaling: float = 1.0) -> torch.Tensor:
    """Per-row tri-LoRA dense: y[i] = x[i]·w + s·x[i]·A[g]·C[g]·B[g] with
    g = rows[i] (-1 = masked → exactly-zero row).  x (B,K); w (K,N); bank
    a (m,K,r) / c (m,r,r) / b (m,r,N).  → (B,N) in x.dtype.  K and N need
    not be tile multiples.  On CUDA a row index >= m is not checked (that
    would cost a host sync): the kernel clamps it to m-1; callers pass rows
    from :meth:`AdapterBank.lookup`, which are in range."""
    rows = torch.as_tensor(rows, dtype=torch.int32, device=x.device)
    if not ffi.on_cuda(rows, x, w, a, c, b):
        return ref.grouped_gemv_ref(rows, x, w, a, c, b, scaling=scaling)
    ffi.require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
                f"x {tuple(x.shape)} @ w {tuple(w.shape)}")
    bsz, k = x.shape
    n = w.shape[1]
    ffi.require(a.dim() == 3 and c.dim() == 3 and b.dim() == 3,
                "bank factors must be stacked (m, …) 3-D tensors")
    m, r = a.shape[0], a.shape[2]
    ffi.require(tuple(a.shape) == (m, k, r) and tuple(c.shape) == (m, r, r)
                and tuple(b.shape) == (m, r, n),
                f"bank shapes A{tuple(a.shape)} C{tuple(c.shape)} "
                f"B{tuple(b.shape)} do not fit x {tuple(x.shape)} @ w "
                f"{tuple(w.shape)}")
    ffi.require(tuple(rows.shape) == (bsz,),
                f"rows shape {tuple(rows.shape)} != ({bsz},)")
    ffi.require(bsz >= 1, "the kernel takes at least one row")
    ffi.require(1 <= r <= GEMV_MAX_RANK,
                f"rank {r}; the kernel takes 1..{GEMV_MAX_RANK}")
    ffi.require(x.dtype in ffi.DTYPE_CODE and w.dtype == x.dtype,
                f"x {x.dtype} / w {w.dtype}: the kernel takes one of "
                f"{list(ffi.DTYPE_CODE)} for both")
    ffi.require(a.dtype == c.dtype == b.dtype == torch.float32,
                f"the bank must be float32, got "
                f"{a.dtype}/{c.dtype}/{b.dtype}")
    for name, t in (("rows", rows), ("x", x), ("w", w), ("A", a), ("C", c),
                    ("B", b)):
        ffi.require(t.is_contiguous(), f"{name} must be contiguous")
    out = torch.empty((bsz, n), dtype=x.dtype, device=x.device)
    p = torch.empty((bsz, r), dtype=torch.float32, device=x.device)
    fn = ffi.fn("grouped_gemv", "grouped_gemv_launch",
                [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                 _I, _F, _VP])
    code = fn(ffi.DTYPE_CODE[x.dtype], rows.data_ptr(), x.data_ptr(),
              w.data_ptr(), a.data_ptr(), c.data_ptr(), b.data_ptr(),
              p.data_ptr(), out.data_ptr(), bsz, k, n, r, m, float(scaling),
              ffi.stream())
    ffi.check("grouped_gemv", code)
    LAUNCHES["grouped_gemv"] += 1
    return out


# ---------------------------------------------------------------------------
# grouped decode composite
# ---------------------------------------------------------------------------

def grouped_decode(x, weights, bank, rows, pos, k_cache, v_cache, *,
                   scaling: float = 1.0):
    """One decode step for a batch of sequences, EACH applying its own
    tri-LoRA adapter row from a stacked bank.

    x (B,d): current-token hidden states (rope is not applied at this
    level).  weights: {'wq','wk','wv','wo'} base projections.  bank: same
    keys, each an {'A': (m,d,r), 'C': (m,r,r), 'B': (m,r,·)} stacked
    adapter.  rows (B,) int32 bank row per sequence (-1 = masked slot).
    pos (B,) int32 absolute position of the incoming token per row.
    k/v_cache (B,R,KH,hd) ring caches, written IN PLACE (a functional copy
    would copy the whole cache every step).

    Returns (out (B,d), k_cache, v_cache).  Masked slots write nothing to
    their cache rows and their output rows are exactly zero.  Plain
    version: :func:`.ref.grouped_decode_ref`.
    """
    bsz = x.shape[0]
    kh, hd = k_cache.shape[2], k_cache.shape[3]
    h = weights["wq"].shape[1] // hd
    rows = torch.as_tensor(rows, dtype=torch.int32, device=x.device)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos = torch.where(rows >= 0, pos, torch.full_like(pos, -1))

    def gd(xin, name):
        ad = bank[name]
        return grouped_dense(rows, xin, weights[name], ad["A"], ad["C"],
                             ad["B"], scaling=scaling)

    q = gd(x, "wq").reshape(bsz, 1, h, hd)
    ref.ragged_cache_write(k_cache, gd(x, "wk").reshape(bsz, kh, hd), pos)
    ref.ragged_cache_write(v_cache, gd(x, "wv").reshape(bsz, kh, hd), pos)
    attn = decode_attention(q, k_cache, v_cache, pos)
    out = gd(attn.reshape(bsz, h * hd), "wo")
    return out, k_cache, v_cache
