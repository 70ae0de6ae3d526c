"""The tri-LoRA projection y = x@W + s·x@A@C@B, trainable: the forward
kernel, and a backward that runs the dx and dW kernels
(``csrc/tri_lora.cu``, built by :mod:`repro_torch.kernels.build`).

:func:`tri_lora_matmul` takes its plain version (:mod:`.ref`, backward by
:func:`.ref.tri_lora_bwd_ref`) when the tensors lie on the CPU.  On CUDA
tensors it launches the kernels through a ``torch.autograd.Function`` or
raises: each kernel wrapper checks device, dtype, shapes and unit inner
stride first, and raises when a launch reports an error.  ``LAUNCHES``
counts kernel launches per kernel (one per op call, one launch on the card
each), ``ROUTES`` the forward's launches by route.

The forward has two hand-written kernels, and :func:`fwd_route` picks one
from the operands' type and layout before the launch: bf16 x and W that TMA
can address (16-byte aligned base and row stride) take the ``wgmma``
kernel, everything else (f32, or a bf16 view TMA cannot read) the
register-tiled ``simt`` kernel.  Both are checked on the card; a failed
build or launch raises on either route.  dx runs the same register-tiled
micro-kernel with g and W both read in place; dW splits its M contraction
(:func:`dw_plan`) over the blocks of one thread-block cluster per output
tile, which sum their partials in split order.

As in the JAX package's op (``repro.kernels.tri_lora.ops``), the rank-r
products stay plain: P = s·(x@A)@C (rounded to x's dtype) feeds the
forward kernel, Q = s·(g@Bᵀ)@Cᵀ the dx kernel, and dA, dC, dB are rank-r
chains.  dx is launched only when x needs a gradient and dW only when W
does (a frozen backbone never runs the dW kernel).  The JAX op's tile
arguments (``bm/bn/bk``), ``interpret`` and ``fused_bwd`` have no
counterpart: the kernels pick their own tiles and mask ragged edges rather
than padding, there is no interpret mode on the card, and the backward is
always the kernels on CUDA and the plain chain on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ffi
from repro_torch.kernels.tri_lora import ref

#: Kernel launches per kernel; incremented only where a kernel is launched.
LAUNCHES = {"tri_lora_fwd": 0, "tri_lora_dx": 0, "tri_lora_dw": 0}
#: Forward launches by route (:func:`fwd_route`).
ROUTES = {"fwd_wgmma": 0, "fwd_simt": 0}

MAX_RANK = 64
#: TMA reads rows whose base and stride are multiples of 16 bytes.
TMA_ALIGN = 16
#: dW plan: the most splits (one cluster of blocks; 8 is the portable
#: cluster size), the fewest contraction rows a split is worth, the
#: kernel's output tile (64 x 64) and its contraction slab.
DW_MAX_SPLITS = 8
DW_MIN_ROWS = 256
DW_TILE = 64
DW_SLAB = 32
_LIB = "tri_lora"
_VP, _I, _LL = ffi.VP, ffi.I, ffi.LL
_RANKED = [_I, _I] + [_VP, _LL] * 5 + [_I] * 4 + [_VP]
_FWD_ENTRY = {"simt": "tri_lora_fwd_launch",
              "wgmma": "tri_lora_fwd_wgmma_launch"}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def _check_2d(name: str, t: torch.Tensor, shape: tuple) -> None:
    ffi.require(tuple(t.shape) == shape,
                f"{name} has shape {tuple(t.shape)}, expected {shape}")
    ffi.require(t.dtype in ffi.DTYPE_CODE,
                f"{name} is {t.dtype}; the kernels take one of "
                f"{list(ffi.DTYPE_CODE)}")
    ffi.require(t.stride(1) == 1 or t.shape[1] == 1,
                f"{name} must be contiguous along its last axis (unit "
                f"stride); got strides {t.stride()}")


def _check_ranked(big: tuple, small: tuple) -> None:
    """``big`` (the large operands, one dtype) and ``small`` (the rank-r
    factor, any kernel dtype), each a tuple of (name, tensor, shape)."""
    for name, t, shape in big + small:
        _check_2d(name, t, shape)
    dts = {t.dtype for _, t, _ in big}
    ffi.require(len(dts) == 1, f"{', '.join(n for n, _, _ in big)} must "
                f"share one dtype; got {sorted(map(str, dts))}")
    ffi.require(ffi.on_cuda(*(t for _, t, _ in big + small)),
                "the tri-LoRA kernels take CUDA tensors; the CPU path is "
                "tri_lora_matmul's plain version")


def _rank_of(r: int) -> int:
    ffi.require(1 <= r <= MAX_RANK, f"rank {r} outside 1..{MAX_RANK}")
    return r


def _tma_ok(t: torch.Tensor) -> bool:
    """TMA can read the 2-D operand ``t`` in place: unit inner stride, a
    row stride of at least one row, base and row stride in 16-byte units."""
    row = t.stride(0) * t.element_size()
    return (t.stride(1) == 1 and t.stride(0) >= t.shape[1]
            and t.data_ptr() % TMA_ALIGN == 0 and row % TMA_ALIGN == 0)


def fwd_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The forward kernel for x (M,K) and w (K,N): ``"wgmma"`` when both
    are bf16 and TMA can read them in place, else ``"simt"``.  Decided from
    dtypes, strides and base addresses alone, before any launch."""
    bf16 = x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
    return "wgmma" if bf16 and _tma_ok(x) and _tma_ok(w) else "simt"


def tri_lora_fwd(x: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Forward kernel: x (M,K) @ w (K,N) + p (M,r) @ b (r,N) → (M,N) in
    x.dtype, f32 accumulation seeded with p@b; the route by
    :func:`fwd_route`."""
    m, k = x.shape
    n = w.shape[1]
    r = _rank_of(p.shape[1])
    _check_ranked((("x", x, (m, k)), ("w", w, (k, n)), ("p", p, (m, r))),
                  (("b", b, (r, n)),))
    route = fwd_route(x, w)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = ffi.fn(_LIB, _FWD_ENTRY[route], _RANKED)
    code = fn(ffi.DTYPE_CODE[x.dtype], ffi.DTYPE_CODE[b.dtype],
              x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
              p.data_ptr(), p.stride(0), b.data_ptr(), b.stride(0),
              y.data_ptr(), y.stride(0), m, k, n, r, ffi.stream())
    ffi.check(_LIB, code)
    LAUNCHES["tri_lora_fwd"] += 1
    ROUTES[f"fwd_{route}"] += 1
    return y


def tri_lora_dx(g: torch.Tensor, w: torch.Tensor, q: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
    """dx kernel: g (M,N) @ wᵀ + q (M,r) @ aᵀ → (M,K) in g.dtype, with w
    (K,N) and a (K,r) read in place."""
    m, n = g.shape
    k = w.shape[0]
    r = _rank_of(q.shape[1])
    _check_ranked((("g", g, (m, n)), ("w", w, (k, n)), ("q", q, (m, r))),
                  (("a", a, (k, r)),))
    dx = torch.empty((m, k), dtype=g.dtype, device=g.device)
    fn = ffi.fn(_LIB, "tri_lora_dx_launch", _RANKED)
    code = fn(ffi.DTYPE_CODE[g.dtype], ffi.DTYPE_CODE[a.dtype],
              g.data_ptr(), g.stride(0), w.data_ptr(), w.stride(0),
              q.data_ptr(), q.stride(0), a.data_ptr(), a.stride(0),
              dx.data_ptr(), dx.stride(0), m, k, n, r, ffi.stream())
    ffi.check(_LIB, code)
    LAUNCHES["tri_lora_dx"] += 1
    return dx


_DW_CAPACITY: dict = {}


def dw_capacity(device: torch.device) -> dict:
    """{S: the dW blocks the CUDA ``device`` holds at once when they are
    launched in clusters of S}, for S = 1..``DW_MAX_SPLITS``, from the
    occupancy calculator (read once per device).  On the H100 clusters of
    3 or more blocks reach only some of its SMs, so it falls with S."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _DW_CAPACITY:
        fn = ffi.fn(_LIB, "tri_lora_dw_capacity", [_I])
        with torch.cuda.device(index):
            cap = {s: fn(s) for s in range(1, DW_MAX_SPLITS + 1)}
        ffi.require(all(c > 0 for c in cap.values()),
                    f"the occupancy of the dW kernel could not be read: "
                    f"{cap}")
        _DW_CAPACITY[index] = cap
    return _DW_CAPACITY[index]


def dw_plan(m: int, k: int, n: int, capacity: dict) -> tuple:
    """(splits, rows per split) of dW's M contraction: the most splits S,
    at most ``DW_MAX_SPLITS``, none shorter than ``DW_MIN_ROWS`` rows (so
    M below two of those is one split), whose 64×64 output tiles × S
    blocks the card holds at once (``capacity[S]``, :func:`dw_capacity`),
    so that one wave of the launch covers dW; rows per split a multiple of
    the slab."""
    tiles = -(-k // DW_TILE) * -(-n // DW_TILE)
    splits = max([1] + [s for s in range(2, DW_MAX_SPLITS + 1)
                        if s <= m // DW_MIN_ROWS and tiles * s <= capacity[s]])
    rows = -(-m // splits)
    rows = -(-rows // DW_SLAB) * DW_SLAB
    return -(-m // rows), rows


def tri_lora_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW kernel: xᵀ (K,M) @ g (M,N) → (K,N) in x.dtype, with x (M,K) read
    in place and M as the contraction, split by :func:`dw_plan` and summed
    in split order inside the kernel (bitwise the same from call to
    call)."""
    m, k = x.shape
    n = g.shape[1]
    _check_ranked((("x", x, (m, k)), ("g", g, (m, n))), ())
    splits, rows = dw_plan(m, k, n, dw_capacity(x.device))
    dw = torch.empty((k, n), dtype=x.dtype, device=x.device)
    fn = ffi.fn(_LIB, "tri_lora_dw_launch",
                [_I] + [_VP, _LL] * 3 + [_I] * 5 + [_VP])
    code = fn(ffi.DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0),
              g.data_ptr(), g.stride(0), dw.data_ptr(), dw.stride(0), m, k,
              n, splits, rows, ffi.stream())
    ffi.check(_LIB, code)
    LAUNCHES["tri_lora_dw"] += 1
    return dw


class _TriLora(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, a, c, b, scaling):
        ctx.cuda = ffi.on_cuda(x2, w, a, c, b)
        ctx.scaling = scaling
        ctx.save_for_backward(x2, w, a, c, b)
        if not ctx.cuda:
            return ref.tri_lora_matmul_ref(x2, w, a, c, b, scaling)
        p = scaling * ((x2.float() @ a.float()) @ c.float())
        return tri_lora_fwd(x2, w, p.to(x2.dtype), b)

    @staticmethod
    def backward(ctx, g):
        x2, w, a, c, b = ctx.saved_tensors
        need_x, need_w, need_a, need_c, need_b = ctx.needs_input_grad[:5]
        s = ctx.scaling
        if not ctx.cuda:
            grads = ref.tri_lora_bwd_ref(x2, w, a, c, b, g, s)
            return (*(gr if need else None for gr, need in
                      zip(grads, ctx.needs_input_grad)), None)
        g = g if g.stride(-1) == 1 else g.contiguous()
        gf = g.float()
        af, cf = a.float(), c.float()
        dx = dw = da = dc = db = gc = xa = None
        gb = gf @ b.float().T                           # (M, r)
        if need_x or need_a:
            gc = gb @ cf.T                              # (M, r)
        if need_x:
            dx = tri_lora_dx(g, w, (s * gc).to(g.dtype), a).to(x2.dtype)
        if need_w:
            dw = tri_lora_dw(x2, g).to(w.dtype)
        if need_c or need_b:
            xa = x2.float() @ af                        # (M, r)
        if need_a:
            da = (s * (x2.float().T @ gc)).to(a.dtype)
        if need_c:
            dc = (s * (xa.T @ gb)).to(c.dtype)
        if need_b:
            db = (s * ((xa @ cf).T @ gf)).to(b.dtype)
        return dx, dw, da, dc, db, None


def tri_lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    c: torch.Tensor, b: torch.Tensor,
                    scaling: float = 1.0) -> torch.Tensor:
    """y = x@W + scaling·((x@A)@C)@B for x (…, K), w (K, N), a (K, r),
    c (r, r), b (r, N) → (…, N) in x.dtype; differentiable in all five.
    The leading dims of x are flattened without a copy where its strides
    allow."""
    *lead, k = x.shape
    y = _TriLora.apply(x.reshape(-1, k), w, a, c, b, float(scaling))
    return y.reshape(*lead, w.shape[1])
