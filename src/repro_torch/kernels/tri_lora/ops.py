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

Grouped forms (vectorized clients, :func:`grouped_tri_lora_matmul`): the
rows of x are the folded batches of m clients, and each leading row of x
applies its own client's adapter (``groups``, one int32 index per leading
row; negative: no delta).  The forward and dx kernels take the group index
and a client stride for the factor that varies by client (B, A), so a
strided view of a stacked client state is read in place; P and Q are plain
per-client products (``bmm`` over the gathered factors), and dA, dC and dB
plain per-client rank-r chains summed into each client by one product with
a 0/1 client matrix (no atomics).  dW, where W needs a gradient, is the
single-adapter dW kernel over all clients' rows.  ``LAUNCHES`` counts the
grouped launches under their own keys (``tri_lora_fwd_grouped``,
``tri_lora_dx_grouped``), ``ROUTES`` the grouped forward's routes
(``fwd_grouped_wgmma``, ``fwd_grouped_simt``).  A group index at or past
the number of adapters is not checked on the host (no device sync): the
gather of the plain products raises on it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ffi
from repro_torch.kernels.tri_lora import ref

#: Kernel launches per kernel; incremented only where a kernel is launched.
LAUNCHES = {"tri_lora_fwd": 0, "tri_lora_dx": 0, "tri_lora_dw": 0,
            "tri_lora_fwd_grouped": 0, "tri_lora_dx_grouped": 0}
#: Forward launches by route (:func:`fwd_route`), single and grouped.
ROUTES = {"fwd_wgmma": 0, "fwd_simt": 0, "fwd_grouped_wgmma": 0,
          "fwd_grouped_simt": 0}

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
#: the grouped entry points: the ranked arguments with the factor's client
#: stride, the group indices and the rows per index after the factor
_GROUPED = [_I, _I] + [_VP, _LL] * 4 + [_LL, _VP, _I, _VP, _LL] + [_I] * 4 \
    + [_VP]
_GROUPED_FWD_ENTRY = {"simt": "tri_lora_fwd_grouped_launch",
                      "wgmma": "tri_lora_fwd_grouped_wgmma_launch"}


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


def fwd_route(x: torch.Tensor, w: torch.Tensor,
              rows: int | None = None) -> str:
    """The forward kernel for x (M,K) and w (K,N): ``"wgmma"`` when both
    are bf16 and TMA can read them in place, else ``"simt"``.  Grouped
    (``rows`` rows per group index) takes ``"wgmma"`` only where its tiles
    (64 rows for M <= 64, else 128) lie in one group.  Decided from dtypes,
    shapes, strides and base addresses alone, before any launch."""
    bf16 = x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
    whole = rows is None or rows % (64 if x.shape[0] <= 64 else 128) == 0
    return "wgmma" if bf16 and whole and _tma_ok(x) and _tma_ok(w) \
        else "simt"


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


def _check_groups(groups: torch.Tensor, rows: int, m: int,
                  factor: tuple) -> None:
    """``groups`` (m / rows,) int32, contiguous, on the factor's device;
    ``factor`` (name, tensor, (r0, r1)): a stack (G, r0, r1) of one factor
    per group, unit inner stride (any client and row strides)."""
    name, f, shape = factor
    ffi.require(groups.dtype == torch.int32 and groups.dim() == 1
                and groups.is_contiguous(),
                f"groups must be a contiguous 1-D int32 tensor; got "
                f"{groups.dtype} {tuple(groups.shape)}")
    ffi.require(rows >= 1 and m % rows == 0 and groups.numel() == m // rows,
                f"{m} rows do not split into {groups.numel()} groups of "
                f"{rows}")
    ffi.require(f.dim() == 3 and tuple(f.shape[1:]) == shape
                and f.shape[0] >= 1,
                f"{name} has shape {tuple(f.shape)}, expected (G,) + "
                f"{shape}")
    ffi.require(f.stride(2) == 1 or shape[1] == 1,
                f"{name} must be contiguous along its last axis; got "
                f"strides {f.stride()}")
    ffi.require(f.dtype in ffi.DTYPE_CODE, f"{name} is {f.dtype}")
    ffi.require(ffi.on_cuda(groups, f), "the grouped kernels take CUDA "
                "tensors")


def tri_lora_fwd_grouped(x: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
                         b: torch.Tensor, groups: torch.Tensor,
                         rows: int) -> torch.Tensor:
    """Grouped forward kernel: y[i] = x[i] @ w + p[i] @ b[g(i)] for x (M,K),
    w (K,N), p (M,r), b (G,r,N) (any client stride) → (M,N) in x.dtype,
    where g(i) = groups[i // rows]; a negative group adds nothing.  The
    route by :func:`fwd_route` with ``rows``."""
    m, k = x.shape
    n = w.shape[1]
    r = _rank_of(p.shape[1])
    _check_ranked((("x", x, (m, k)), ("w", w, (k, n)), ("p", p, (m, r))),
                  ())
    _check_groups(groups, rows, m, ("b", b, (r, n)))
    route = fwd_route(x, w, rows)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = ffi.fn(_LIB, _GROUPED_FWD_ENTRY[route], _GROUPED)
    code = fn(ffi.DTYPE_CODE[x.dtype], ffi.DTYPE_CODE[b.dtype],
              x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
              p.data_ptr(), p.stride(0), b.data_ptr(), b.stride(1),
              b.stride(0), groups.data_ptr(), rows, y.data_ptr(),
              y.stride(0), m, k, n, r, ffi.stream())
    ffi.check(_LIB, code)
    LAUNCHES["tri_lora_fwd_grouped"] += 1
    ROUTES[f"fwd_grouped_{route}"] += 1
    return y


def tri_lora_dx_grouped(g: torch.Tensor, w: torch.Tensor, q: torch.Tensor,
                        a: torch.Tensor, groups: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """Grouped dx kernel: dx[i] = g[i] @ wᵀ + q[i] @ a[g(i)]ᵀ for g (M,N),
    w (K,N), q (M,r), a (G,K,r) (any client stride) → (M,K) in g.dtype,
    where g(i) = groups[i // rows]; a negative group adds nothing."""
    m, n = g.shape
    k = w.shape[0]
    r = _rank_of(q.shape[1])
    _check_ranked((("g", g, (m, n)), ("w", w, (k, n)), ("q", q, (m, r))),
                  ())
    _check_groups(groups, rows, m, ("a", a, (k, r)))
    dx = torch.empty((m, k), dtype=g.dtype, device=g.device)
    fn = ffi.fn(_LIB, "tri_lora_dx_grouped_launch", _GROUPED)
    code = fn(ffi.DTYPE_CODE[g.dtype], ffi.DTYPE_CODE[a.dtype],
              g.data_ptr(), g.stride(0), w.data_ptr(), w.stride(0),
              q.data_ptr(), q.stride(0), a.data_ptr(), a.stride(1),
              a.stride(0), groups.data_ptr(), rows, dx.data_ptr(),
              dx.stride(0), m, k, n, r, ffi.stream())
    ffi.check(_LIB, code)
    LAUNCHES["tri_lora_dx_grouped"] += 1
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


class _GroupedTriLora(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, a, c, b, groups, rows, scaling):
        ctx.cuda = ffi.on_cuda(x2, w, a, c, b, groups)
        ctx.rows, ctx.scaling = rows, scaling
        ctx.save_for_backward(x2, w, a, c, b, groups)
        if not ctx.cuda:
            return ref.grouped_tri_lora_matmul_ref(x2, w, a, c, b, groups,
                                                   rows, scaling)
        sel = groups.long().clamp_min(0)
        xs = x2.float().reshape(groups.numel(), rows, -1)
        p = scaling * ((xs @ a[sel].float()) @ c[sel].float())
        return tri_lora_fwd_grouped(x2, w, p.reshape(x2.shape[0], -1).to(
            x2.dtype), b, groups, rows)

    @staticmethod
    def backward(ctx, g):
        x2, w, a, c, b, groups = ctx.saved_tensors
        need_x, need_w, need_a, need_c, need_b = ctx.needs_input_grad[:5]
        s, rows = ctx.scaling, ctx.rows
        if not ctx.cuda:
            grads = ref.grouped_tri_lora_bwd_ref(x2, w, a, c, b, groups, g,
                                                 rows, s)
            return (*(gr if need else None for gr, need in
                      zip(grads, ctx.needs_input_grad)), None, None, None)
        g = g if g.stride(-1) == 1 else g.contiguous()
        e, m = groups.numel(), x2.shape[0]
        sel = groups.long().clamp_min(0)
        af, cf = a[sel].float(), c[sel].float()       # (E, K, r), (E, r, r)
        gs = g.float().reshape(e, rows, -1)
        xs = x2.float().reshape(e, rows, -1)
        gb = gs @ b[sel].float().transpose(1, 2)      # (E, rows, r)
        # the per-entry rank-r grads summed into their groups by one product
        # with the (G, E) 0/1 matrix (a negative group's column is zero)
        onehot = (groups.long()[None, :] == torch.arange(
            a.shape[0], device=g.device)[:, None]).float()
        dx = dw = da = dc = db = gc = xa = None
        if need_x or need_a:
            gc = gb @ cf.transpose(1, 2)              # (E, rows, r)
        if need_x:
            dx = tri_lora_dx_grouped(g, w, (s * gc).reshape(m, -1).to(
                g.dtype), a, groups, rows).to(x2.dtype)
        if need_w:
            dw = tri_lora_dw(x2, g).to(w.dtype)
        if need_c or need_b:
            xa = xs @ af                              # (E, rows, r)
        if need_a:
            da = _into_groups(onehot, s * (xs.transpose(1, 2) @ gc), a)
        if need_c:
            dc = _into_groups(onehot, s * (xa.transpose(1, 2) @ gb), c)
        if need_b:
            db = _into_groups(onehot, s * ((xa @ cf).transpose(1, 2) @ gs),
                              b)
        return dx, dw, da, dc, db, None, None, None


def _into_groups(onehot: torch.Tensor, per_entry: torch.Tensor,
                 like: torch.Tensor) -> torch.Tensor:
    """Σ over the entries of each group: (G, E) @ (E, …) in like's type."""
    g = onehot @ per_entry.reshape(per_entry.shape[0], -1)
    return g.reshape(like.shape).to(like.dtype)


def grouped_tri_lora_matmul(x: torch.Tensor, w: torch.Tensor,
                            a: torch.Tensor, c: torch.Tensor,
                            b: torch.Tensor, groups: torch.Tensor,
                            scaling: float = 1.0) -> torch.Tensor:
    """y[i] = x[i]@W + scaling·((x[i]@A[g])@C[g])@B[g], g = groups[i], for
    each leading row i of x (E, …, K), with stacked factors a (G, K, r),
    c (G, r, r), b (G, r, N) (views of a stacked client state need no
    copy) and groups (E,) int → (E, …, N) in x.dtype; a negative group adds
    no delta (the row keeps x@W).  Differentiable in x, W and the three
    stacks.  The rows of one leading index (``rows`` = the product of x's
    middle dims) share its group."""
    k = x.shape[-1]
    rows = math.prod(x.shape[1:-1])
    y = _GroupedTriLora.apply(x.reshape(-1, k), w, a, c, b,
                              groups.to(torch.int32).contiguous(), rows,
                              float(scaling))
    return y.reshape(*x.shape[:-1], w.shape[1])
