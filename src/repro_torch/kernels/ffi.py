"""Calling the port's CUDA kernels through ``ctypes``: function lookup,
argument checks, launch-error checks and the current stream.

Every kernel library built by :mod:`repro_torch.kernels.build` exports its
launch functions (each returns the ``cudaError_t`` of its launch) and a
``<library>_error_string`` function that names an error code.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

VP, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fn(lib_name: str, fn_name: str, argtypes):
    """The launch function ``fn_name`` of library ``lib_name`` (built at
    first use), with its argument types declared."""
    lib = build.load(lib_name)
    f = getattr(lib, fn_name)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def check(lib_name: str, code: int) -> None:
    """Raise when a launch returned a CUDA error."""
    if code != 0:
        err = getattr(build.load(lib_name), f"{lib_name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        msg = err(code)
        raise RuntimeError(f"{lib_name} kernel launch failed: CUDA error "
                           f"{code} ({msg.decode()})")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def on_cuda(*ts: torch.Tensor) -> bool:
    """False when every tensor lies on the CPU (plain path) or every one on
    ``meta`` (the plain path traced for shapes only: the dry run), True
    when all lie on one CUDA device; anything else raises."""
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs) or \
            all(d.type == "meta" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"the kernels need all operands on one CUDA device "
                         f"(or all on the CPU); got {sorted(map(str, devs))}")
    return True


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
