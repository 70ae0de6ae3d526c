"""Wrappers of the decode kernels: ragged decode attention over a ring
cache, the grouped heterogeneous tri-LoRA dense, and the grouped decode
composite built from them.

Each wrapper takes its plain version (:mod:`.ref`) when the tensors lie on
the CPU.  On a CUDA tensor it launches its hand-written kernel
(``csrc/*.cu``, built by :mod:`repro_torch.kernels.build`) or raises: it
checks device, dtype, shape and strides first, and raises when the launch
reports an error.  ``LAUNCHES`` counts kernel launches per wrapper and
``ROUTES`` the route each took: the 16-byte route (16-byte loads and
copies), or the scalar route (same kernel and order of sums) for operands
whose base or strides are not multiples of 16 bytes.  :func:`attn_plan` and
:func:`gemv_plan` split each launch over blocks before it is made.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ffi
from repro_torch.kernels.decode_attention import ref

#: Kernel launches per wrapper; incremented only where a kernel is launched.
LAUNCHES = {"decode_attention": 0, "grouped_gemv": 0}
#: Launches per route (16-byte ``vec`` or ``scalar``) of each kernel.
ROUTES = {"attn_vec": 0, "attn_scalar": 0, "gemv_vec": 0, "gemv_scalar": 0}

#: The head dims decode_attention.cu is instantiated for (its
#: ``Instantiated`` list): those of the repository's configs.
_ATTN_HEAD_DIMS = (64, 120, 128, 256)
#: Query heads a KV head the attention kernel takes, and the most a block
#: takes when there are several (the kernel's ``heads_per_block``).
ATTN_MAX_GROUP = 64
ATTN_HEADS_PER_BLOCK = 4
#: Blocks of one attention output combined in a cluster: the portable
#: cluster size.
ATTN_MAX_SPLITS = 8
GEMV_MAX_RANK = 32
#: K rows of a ring stage of the GEMV kernel (a K slice is a multiple of
#: it), and the most K slices of a launch.
GEMV_STAGE_K = 64
GEMV_MAX_SPLITS = 16

_VP, _I, _LL, _F = ffi.VP, ffi.I, ffi.LL, ffi.F
_ATTN_CAPACITY: dict = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned16(t: torch.Tensor, strides) -> bool:
    """Base and every given element stride are multiples of 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0
                                          for s in strides)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def attn_capacity(device: torch.device) -> dict:
    """{S: the decode-attention blocks the CUDA ``device`` holds at once
    when they are launched in clusters of S}, S = 1..ATTN_MAX_SPLITS, from
    the occupancy calculator (read once per device).  On the H100 clusters
    of 3 or more blocks reach only some of its SMs, so it falls with S."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _ATTN_CAPACITY:
        fn = ffi.fn("decode_attention", "decode_attention_capacity", [_I])
        with torch.cuda.device(index):
            cap = {s: fn(s) for s in range(1, ATTN_MAX_SPLITS + 1)}
        ffi.require(all(c > 0 for c in cap.values()),
                    f"the occupancy of the decode attention kernel could not "
                    f"be read: {cap}")
        _ATTN_CAPACITY[index] = cap
    return _ATTN_CAPACITY[index]


def attn_plan(batch: int, kv_heads: int, group: int, capacity: dict) -> int:
    """Blocks a row's valid slots are split over (one cluster): the most,
    up to ATTN_MAX_SPLITS, whose launch (B x K x head chunks x splits
    blocks) the card holds in one wave (``capacity[S]``,
    :func:`attn_capacity`); 1 when even that does not fit."""
    blocks = batch * kv_heads * _cdiv(group, ATTN_HEADS_PER_BLOCK)
    return max([1] + [s for s in range(2, ATTN_MAX_SPLITS + 1)
                      if blocks * s <= capacity[s]])


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
    ffi.require(kh >= 1 and h % kh == 0 and h // kh <= ATTN_MAX_GROUP,
                f"{h} query heads over {kh} KV heads (the kernel takes up "
                f"to {ATTN_MAX_GROUP} a KV head)")
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
    splits = attn_plan(b, kh, h // kh, attn_capacity(q.device))
    vec = (_aligned16(k_cache, k_cache.stride()[:3])
           and _aligned16(v_cache, v_cache.stride()[:3]))
    out = torch.empty_like(q)
    fn = ffi.fn("decode_attention", "decode_attention_launch",
                [_I, _I, _I, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _I, _I,
                 _LL, _LL, _LL, _LL, _LL, _LL, _F, _I, _VP])
    code = fn(ffi.DTYPE_CODE[q.dtype], hd, int(vec), q.data_ptr(),
              k_cache.data_ptr(), v_cache.data_ptr(), idx.data_ptr(),
              0 if idx.dim() == 0 else 1, out.data_ptr(), b, h, kh, ring,
              *k_cache.stride()[:3], *v_cache.stride()[:3],
              float(hd) ** -0.5, splits, ffi.stream())
    ffi.check("decode_attention", code)
    ROUTES["attn_vec" if vec else "attn_scalar"] += 1
    LAUNCHES["decode_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# grouped tri-LoRA dense
# ---------------------------------------------------------------------------

def gemv_plan(batch: int, k: int, n: int, itemsize: int, sms: int):
    """(splits, depth) of a grouped-GEMV launch: K is cut into slices of
    ``depth`` rows (a multiple of GEMV_STAGE_K), at most GEMV_MAX_SPLITS,
    the fewest that give every SM two blocks over the tiles (512-byte
    column tiles x row groups of 8, 16 or 32)."""
    maxb = 8 if batch <= 8 else 16 if batch <= 16 else 32
    tiles = _cdiv(n, 32 * (16 // itemsize)) * _cdiv(batch, maxb)
    splits = min(GEMV_MAX_SPLITS, _cdiv(2 * sms, tiles))
    depth = _cdiv(_cdiv(k, splits), GEMV_STAGE_K) * GEMV_STAGE_K
    return _cdiv(k, depth), depth


def gemv_scratch(splits: int, batch: int, n: int, r: int, device):
    """The GEMV's f32 scratch: each K slice's partial output (rows padded
    to a multiple of 4 columns) and its share of x·A[g]."""
    part = torch.empty((splits, batch, _cdiv(n, 4) * 4), dtype=torch.float32,
                       device=device)
    xa_part = torch.empty((splits, batch, r), dtype=torch.float32,
                          device=device)
    return part, xa_part


def grouped_dense(rows, x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                  c: torch.Tensor, b: torch.Tensor, *,
                  scaling: float = 1.0) -> torch.Tensor:
    """Per-row tri-LoRA dense: y[i] = x[i]·w + s·x[i]·A[g]·C[g]·B[g] with
    g = rows[i] (-1 = masked → exactly-zero row).  x (B,K); w (K,N), read
    through its row stride (a column slice is taken as it is); bank
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
    for name, t in (("rows", rows), ("x", x), ("A", a), ("C", c), ("B", b)):
        ffi.require(t.is_contiguous(), f"{name} must be contiguous")
    ffi.require(w.stride(1) == 1 and w.stride(0) >= n,
                f"w must have contiguous columns (unit column stride), got "
                f"strides {tuple(w.stride())}")
    size = x.element_size()
    splits, depth = gemv_plan(bsz, k, n, size, _sms(x.device.index or 0))
    vec = _aligned16(w, (w.stride(0),)) and _aligned16(x, (k,))
    out = torch.empty((bsz, n), dtype=x.dtype, device=x.device)
    part, xa_part = gemv_scratch(splits, bsz, n, r, x.device)
    fn = ffi.fn("grouped_gemv", "grouped_gemv_launch",
                [_I, _I, _VP, _VP, _VP, _LL, _VP, _VP, _VP, _VP, _VP, _VP,
                 _I, _I, _I, _I, _I, _F, _I, _I, _VP])
    code = fn(ffi.DTYPE_CODE[x.dtype], int(vec), rows.data_ptr(),
              x.data_ptr(), w.data_ptr(), w.stride(0), a.data_ptr(),
              c.data_ptr(), b.data_ptr(), part.data_ptr(), xa_part.data_ptr(),
              out.data_ptr(), bsz, k, n, r, m, float(scaling), splits, depth,
              ffi.stream())
    ffi.check("grouped_gemv", code)
    ROUTES["gemv_vec" if vec else "gemv_scalar"] += 1
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
