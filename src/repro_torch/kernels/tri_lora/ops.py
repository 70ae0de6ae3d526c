"""The tri-LoRA projection y = x@W + s·x@A@C@B, trainable: the forward
kernel, and a backward that runs the dx and dW kernels
(``csrc/tri_lora.cu``, built by :mod:`repro_torch.kernels.build`).

:func:`tri_lora_matmul` takes its plain version (:mod:`.ref`, backward by
:func:`.ref.tri_lora_bwd_ref`) when the tensors lie on the CPU.  On CUDA
tensors it launches the kernels through a ``torch.autograd.Function`` or
raises: each kernel wrapper checks device, dtype, shapes and unit inner
stride first, and raises when a launch reports an error.  ``LAUNCHES``
counts kernel launches per kernel.

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

MAX_RANK = 64
_LIB = "tri_lora"
_VP, _I, _LL = ffi.VP, ffi.I, ffi.LL
_RANKED = [_I, _I] + [_VP, _LL] * 5 + [_I] * 4 + [_VP]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def tri_lora_fwd(x: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Forward kernel: x (M,K) @ w (K,N) + p (M,r) @ b (r,N) → (M,N) in
    x.dtype, f32 accumulation seeded with p@b."""
    m, k = x.shape
    n = w.shape[1]
    r = _rank_of(p.shape[1])
    _check_ranked((("x", x, (m, k)), ("w", w, (k, n)), ("p", p, (m, r))),
                  (("b", b, (r, n)),))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = ffi.fn(_LIB, "tri_lora_fwd_launch", _RANKED)
    code = fn(ffi.DTYPE_CODE[x.dtype], ffi.DTYPE_CODE[b.dtype],
              x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
              p.data_ptr(), p.stride(0), b.data_ptr(), b.stride(0),
              y.data_ptr(), y.stride(0), m, k, n, r, ffi.stream())
    ffi.check(_LIB, code)
    LAUNCHES["tri_lora_fwd"] += 1
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


def tri_lora_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW kernel: xᵀ (K,M) @ g (M,N) → (K,N) in x.dtype, with x (M,K) read
    in place and M as the contraction."""
    m, k = x.shape
    n = g.shape[1]
    _check_ranked((("x", x, (m, k)), ("g", g, (m, n))), ())
    dw = torch.empty((k, n), dtype=x.dtype, device=x.device)
    fn = ffi.fn(_LIB, "tri_lora_dw_launch",
                [_I] + [_VP, _LL] * 3 + [_I] * 3 + [_VP])
    code = fn(ffi.DTYPE_CODE[x.dtype], x.data_ptr(), x.stride(0),
              g.data_ptr(), g.stride(0), dw.data_ptr(), dw.stride(0), m, k,
              n, ffi.stream())
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
