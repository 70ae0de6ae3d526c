"""The WKV6 recurrence of RWKV-6, forward only: the ``wkv6`` kernel
(``csrc/wkv6.cu``, built by :mod:`repro_torch.kernels.build`).

:func:`wkv6` takes the model's (B,T,H,hd) layout, as the JAX package's
``repro.kernels.rwkv6.ops.wkv6`` does.  On CPU tensors it runs the plain
version that the JAX kernel computes in interpret mode: the log-space
chunked recurrence at chunk 32 (``models.rwkv.wkv_chunked``).  On CUDA
tensors it launches the kernel or raises: it checks device, dtypes,
shapes and unit inner stride first, and raises when the launch reports an
error.  The kernel reads r, k, v and w by strides (a (B,T,3·D) buffer's
views need no copy), takes u as (H,hd) without a per-row broadcast, pads
nothing and masks the ragged last chunk by the real T.  ``LAUNCHES``
counts kernel launches.

The kernel stages r, k, v and w 16 bytes a copy; operands it cannot read
that way (a base, a batch, time or head stride, or a row of hd elements
that is no multiple of 16 bytes) take the same kernel's scalar route, one
element a load.  :func:`route` picks it before the launch, and ``ROUTES``
counts the launches by route.

The JAX op's ``chunk`` and ``interpret`` arguments have no counterpart:
the kernel runs the recurrence step by step, and there is no interpret
mode on the card.  Like the JAX kernel it has no VJP: a call that
autograd would have to differentiate raises, whatever the device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ffi
from repro_torch.models import rwkv

#: Kernel launches; incremented only where the kernel is launched.
LAUNCHES = {"wkv6": 0}
#: Launches by route (:func:`route`).
ROUTES = {"wkv6_vec": 0, "wkv6_scalar": 0}
#: The 16-byte route reads rows whose base and strides are multiples of it.
ALIGN = 16

#: Head dims the kernel takes (``kMaxHd`` of ``csrc/wkv6.cu``): one block
#: of a (b, h) holds every key and value column up to it.
MAX_HD = 64
_LIB = "wkv6"
_VP, _I, _LL = ffi.VP, ffi.I, ffi.LL
_ARGS = ([_I] * 3 + [_VP, _LL, _LL, _LL] * 4 + [_VP, _LL]
         + [_VP, _LL, _LL, _LL] + [_VP, _VP] + [_I] * 4 + [_VP])


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def route(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor) -> str:
    """The kernel's route: ``"vec"`` when r, k, v and w each have a base
    address, batch, time and head strides and a row of hd elements that
    are multiples of 16 bytes, else ``"scalar"``.  Decided from strides and
    base addresses alone, before any launch."""
    def rows16(t):
        n = t.element_size()
        return t.data_ptr() % ALIGN == 0 and all(
            s * n % ALIGN == 0 for s in (*t.stride()[:3], t.shape[-1]))
    return "vec" if all(rows16(t) for t in (r, k, v, w)) else "scalar"


def _check_cuda(r, k, v, w, u, state) -> None:
    b, t, h, hd = r.shape
    ffi.require(1 <= hd <= MAX_HD,
                f"the wkv6 kernel takes head dims 1..{MAX_HD}; got {hd}")
    ffi.require(t >= 1 and b >= 1 and h >= 1, f"empty input {tuple(r.shape)}")
    for name, a in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        ffi.require(a.dtype in ffi.DTYPE_CODE,
                    f"{name} is {a.dtype}; the kernel takes one of "
                    f"{list(ffi.DTYPE_CODE)}")
        ffi.require(a.stride(-1) == 1 or a.shape[-1] == 1,
                    f"{name} must be contiguous along its last axis (unit "
                    f"stride); got strides {a.stride()}")
    ffi.require(r.dtype == k.dtype == v.dtype,
                f"r, k and v must share one dtype; got {r.dtype}, "
                f"{k.dtype}, {v.dtype}")
    ffi.require(state.dtype == torch.float32,
                f"the state is carried in float32; got {state.dtype}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor) -> tuple:
    """r,k,v,w: (B,T,H,hd) — w ∈ (0,1); u: (H,hd); state: (B,H,hd,hd) f32
    (key × value).  Returns (y (B,T,H,hd) f32, new state (B,H,hd,hd)
    f32)."""
    ins = (r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(a.requires_grad for a in ins):
        raise RuntimeError(
            "wkv6 is forward-only: the JAX kernel it ports "
            "(repro.kernels.rwkv6) has no VJP.  Differentiate through the "
            "plain recurrences instead (use_rwkv_kernel=False), or call it "
            "under torch.no_grad() / torch.inference_mode()")
    b, t, h, hd = r.shape
    for name, a, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("w", w, r.shape), ("u", u, (h, hd)),
                           ("state", state, (b, h, hd, hd))):
        ffi.require(tuple(a.shape) == tuple(shape),
                    f"{name} has shape {tuple(a.shape)}, expected "
                    f"{tuple(shape)}")
    if not ffi.on_cuda(*ins):
        return rwkv.wkv_chunked(r, k, v, w, u, state, chunk=32)
    _check_cuda(*ins)
    y = torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    how = route(r, k, v, w)
    fn = ffi.fn(_LIB, "wkv6_launch" if how == "vec" else "wkv6_scalar_launch",
                _ARGS)
    code = fn(ffi.DTYPE_CODE[r.dtype], ffi.DTYPE_CODE[w.dtype],
              ffi.DTYPE_CODE[u.dtype],
              *(x for a in (r, k, v, w)
                for x in (a.data_ptr(), a.stride(0), a.stride(1),
                          a.stride(2))),
              u.data_ptr(), u.stride(0),
              state.data_ptr(), state.stride(0), state.stride(1),
              state.stride(2), y.data_ptr(), s_out.data_ptr(), b, t, h, hd,
              ffi.stream())
    ffi.check(_LIB, code)
    LAUNCHES["wkv6"] += 1
    ROUTES[f"wkv6_{how}"] += 1
    return y, s_out
