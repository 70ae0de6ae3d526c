"""Flash attention in the model layout, trainable: the forward kernel saves
the logsumexp, and the backward runs the dq and dk/dv kernels
(``csrc/flash_attention.cu``, built by :mod:`repro_torch.kernels.build`).

:func:`flash_attention` takes its plain version (:mod:`.ref`, backward by
autograd) when the tensors lie on the CPU.  On CUDA tensors it launches the
kernels through a ``torch.autograd.Function`` or raises: it checks device,
dtype, head dim and layout first, and raises when a launch reports an
error.  ``LAUNCHES`` counts kernel launches per kernel.

Every kernel stages its tiles 16 bytes a read; operands it cannot read
that way (a base or a batch, sequence or head stride that is no multiple
of 16 bytes) take the same kernel's scalar route, one element a read.
:func:`fwd_route` and :func:`bwd_route` pick the route before the launch,
and ``ROUTES`` counts the launches by route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ffi
from repro_torch.kernels.flash_attention import ref

#: Kernel launches per kernel; incremented only where a kernel is launched.
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
#: Forward launches by route (:func:`fwd_route`), dq and dk/dv launches by
#: route (:func:`bwd_route`).
ROUTES = {"fwd_vec": 0, "fwd_scalar": 0, "bwd_vec": 0, "bwd_scalar": 0}
#: The 16-byte route reads rows whose base and strides are multiples of it.
ALIGN = 16

#: The head dims the kernels are built for (``dispatch`` in the .cu); 256
#: computes on 32-row tiles, the others on 64-row ones.  Any other head dim
#: raises: there is no plain fallback on CUDA tensors.
HEAD_DIMS = (64, 120, 128, 256)
_LIB = "flash_attention"
_VP, _I, _LL, _F = ffi.VP, ffi.I, ffi.LL, ffi.F


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def _check_operands(q, k, v, window: int) -> None:
    ffi.require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
                and q.shape[0] == k.shape[0] and q.shape[3] == k.shape[3],
                f"q {tuple(q.shape)} and k/v {tuple(k.shape)}/"
                f"{tuple(v.shape)} are not (B,Sq,H,hd) and (B,Skv,K,hd)")
    h, kh, hd = q.shape[2], k.shape[2], q.shape[3]
    ffi.require(kh >= 1 and h % kh == 0, f"{h} query heads over {kh} KV heads")
    ffi.require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    ffi.require(q.dtype in ffi.DTYPE_CODE and k.dtype == q.dtype
                and v.dtype == q.dtype,
                f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}; the kernels "
                f"take one of {list(ffi.DTYPE_CODE)} for all three")
    ffi.require(q.stride(3) == 1 and k.stride(3) == 1 and v.stride(3) == 1,
                "q/k/v channels must be contiguous (unit stride)")
    ffi.require(window >= 0, f"window {window} < 0")


def _strides(t: torch.Tensor) -> tuple:
    return t.stride(0), t.stride(1), t.stride(2)


def _rows16(t: torch.Tensor) -> bool:
    return t.data_ptr() % ALIGN == 0 and all(
        s * t.element_size() % ALIGN == 0 for s in t.stride()[:3])


def fwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The forward's route: ``"vec"`` when q, k and v each have a base
    address and batch, sequence and head strides that are multiples of 16
    bytes, else ``"scalar"``.  Decided from strides and base addresses
    alone, before any launch."""
    return "vec" if all(_rows16(t) for t in (q, k, v)) else "scalar"


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """Forward kernel: (out (B,Sq,H,hd) in q.dtype, lse (B,H,Sq) f32);
    the route by :func:`fwd_route`."""
    _check_operands(q, k, v, window)
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    route = fwd_route(q, k, v)
    name = "flash_fwd_launch" if route == "vec" else "flash_fwd_scalar_launch"
    fn = ffi.fn(_LIB, name,
                [_I, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I]
                + [_LL] * 9 + [_F, _I, _I, _VP])
    code = fn(ffi.DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
              v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, skv, h,
              kh, *_strides(q), *_strides(k), *_strides(v),
              float(hd) ** -0.5, int(causal), int(window), ffi.stream())
    ffi.check(_LIB, code)
    LAUNCHES["flash_fwd"] += 1
    ROUTES[f"fwd_{route}"] += 1
    return out, lse


def _check_bwd(q, k, v, do, lse, delta, window: int) -> None:
    _check_operands(q, k, v, window)
    ffi.require(do.shape == q.shape and do.dtype == q.dtype
                and do.stride(3) == 1,
                f"dO {tuple(do.shape)} {do.dtype} does not match q")
    rows = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        ffi.require(tuple(t.shape) == rows and t.dtype == torch.float32
                    and t.is_contiguous(),
                    f"{name} {tuple(t.shape)} {t.dtype} is not contiguous "
                    f"(B,H,Sq) f32")


def _bwd_args(q, k, v, do, causal: bool, window: int) -> tuple:
    b, sq, h, _ = q.shape
    skv, kh = k.shape[1], k.shape[2]
    return (b, sq, skv, h, kh, *_strides(q), *_strides(k), *_strides(v),
            *_strides(do), float(q.shape[3]) ** -0.5, int(causal),
            int(window), ffi.stream())


_BWD_TAIL = [_I] * 5 + [_LL] * 12 + [_F, _I, _I, _VP]


def bwd_route(*ts: torch.Tensor) -> str:
    """The backward's route for operands ``ts`` (q, k, v, dO): ``"vec"``
    when each one's base address and batch, sequence and head strides are
    multiples of 16 bytes, else ``"scalar"``.  Decided from strides and
    base addresses alone, before any launch."""
    return "vec" if all(_rows16(t) for t in ts) else "scalar"


def _bwd_fn(kernel: str, route: str, n_ptrs: int):
    name = f"flash_{kernel}_launch" if route == "vec" else \
        f"flash_{kernel}_scalar_launch"
    return ffi.fn(_LIB, name, [_I, _I] + [_VP] * n_ptrs + _BWD_TAIL)


def softmax_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = Σ_d dO·O per query row, (B,H,Sq) f32 — the softmax-Jacobian
    row correction of the backward (plain PyTorch, as the JAX wrapper
    leaves it to XLA)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                       window: int = 0) -> torch.Tensor:
    """dq kernel: (B,Sq,H,hd) in q.dtype; the route by :func:`bwd_route`."""
    _check_bwd(q, k, v, do, lse, delta, window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    route = bwd_route(q, k, v, do)
    fn = _bwd_fn("dq", route, 7)
    code = fn(ffi.DTYPE_CODE[q.dtype], q.shape[3], q.data_ptr(),
              k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), dq.data_ptr(),
              *_bwd_args(q, k, v, do, causal, window))
    ffi.check(_LIB, code)
    LAUNCHES["flash_dq"] += 1
    ROUTES[f"bwd_{route}"] += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                        window: int = 0) -> tuple:
    """dk/dv kernel: (dk, dv), each (B,Skv,K,hd) in k.dtype, each summed
    over the G query heads of its KV head in a fixed order; the route by
    :func:`bwd_route`."""
    _check_bwd(q, k, v, do, lse, delta, window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    route = bwd_route(q, k, v, do)
    fn = _bwd_fn("dkv", route, 8)
    code = fn(ffi.DTYPE_CODE[q.dtype], q.shape[3], q.data_ptr(),
              k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              *_bwd_args(q, k, v, do, causal, window))
    ffi.check(_LIB, code)
    LAUNCHES["flash_dkv"] += 1
    ROUTES[f"bwd_{route}"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int = 0) -> tuple:
    """Backward kernels: (dq, dk, dv) for output cotangent ``do``."""
    delta = softmax_delta(out, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal=causal,
                            window=window)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal=causal,
                                 window=window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,K,hd), H % K == 0 → (B,Sq,H,hd) in
    q.dtype; differentiable in q, k and v.  Causal rows are the last ``Sq``
    of the ``Skv``-long sequence; a window applies to causal attention
    only; keys beyond ``Skv`` do not exist (no padding is ever attended)."""
    if not ffi.on_cuda(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))
