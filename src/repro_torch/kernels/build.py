"""Build and load the port's CUDA kernels.

Every ``kernels/*/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface under
``<checkout>/build/kernels/``, and loaded with ``ctypes``.  A library is
named by the hash of its source and flags, so it is built at first use and
again whenever the source changes.  All stale sources are compiled in
parallel, one ``nvcc`` each.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Built:
    name: str
    source: Path
    library: Path
    seconds: float        # 0.0 when an up-to-date library was reused
    log: str              # nvcc/ptxas output of the build ("" if reused)


def sources() -> Dict[str, Path]:
    """{kernel name: .cu path} for every kernel source in the package."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Built]:
    """Build every kernel whose library is missing or stale, all nvcc
    processes started together.  Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Built] = {}
    procs = {}
    for n, src in sources().items():
        lib = _library_path(src)
        if lib.exists():
            out[n] = Built(n, src, lib, 0.0, "")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    time.perf_counter(), src, lib, tmp)
    failed = []
    for n, (proc, t0, src, lib, tmp) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(log)
        out[n] = Built(n, src, lib, secs, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed (with
    every other stale kernel source, in parallel)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            built = build_all()
            for n, b in built.items():
                if n not in _LIBS:
                    _LIBS[n] = ctypes.CDLL(str(b.library))
            lib = _LIBS[name]
        return lib
