"""Identity-keyed cache for compiled programs, and the programs: PyTorch
port of ``repro.core.jit_cache``, with the port's counterpart of
``jax.jit``.

The federated runtime reuses its compiled local-fit and eval programs
across calls (and across ``run_federated`` calls on the same task).  The
programs close over the task's parameter tensors, so the cache key must
identify *those objects* — but a bare ``id()`` key is a latent bug: once
the anchoring object is garbage-collected, CPython can hand its id to a
brand-new, different task, silently serving a program built against the
wrong parameters.  And a plain dict grows without bound.

:class:`JitCache` fixes both, exactly as the JAX package's does:

* every entry holds STRONG references to its anchor objects, so an id in
  the table always refers to a live object and id reuse against a live
  entry is impossible (two live objects never share an id);
* lookups re-verify ``is``-identity of the stored anchors, so even a
  hypothetical collision cannot serve a stale program;
* LRU eviction bounds the table (and releases the anchors, after which
  their ids are free to be reused — against a now-absent entry).

The program (:func:`program`, what ``jax.jit`` compiles in the JAX
package) is, on a CUDA device, a captured ``torch.cuda.CUDAGraph`` of the
function for one input signature — tree structure, and every tensor's
shape, strides, dtype, device and 16-byte alignment (the kernels pick
their routes by alignment).  It is built in three steps: static input
buffers laid out as the inputs, a warm-up call on them on a side stream
(it builds the kernels, sets their attributes and initializes the
autograd and cuBLAS state), and the capture, in ``thread_local`` mode (a
data-prefetch thread may allocate pinned memory meanwhile).  A call
copies its inputs into those buffers,
replays the graph and returns clones of the static outputs, which the next
replay overwrites.  A replay runs no Python, so the kernel wrappers'
launch counters (``LAUNCHES`` / ``ROUTES`` in ``kernels/*/ops.py``) would
stop: a program leaves the warm-up and the capture uncounted and adds the
counts of the capture on every replay, so they stay exact.  On the CPU the
program is the function itself (no graphs there; the plain path is the
parity anchor).  A failed warm-up, capture or replay raises: nothing
falls back to running eagerly.

:func:`jit` puts the two together: the function it returns looks up the
program for its arguments' signature in a cache and calls it, building
it on a miss.  :func:`disable_jit` (``jax.disable_jit``'s counterpart)
makes every such function run plain while it is active: no capture, no
replay, no new entry.  Cached programs keep their anchors, their static
buffers and their graph's memory pool until they are evicted or their
cache is cleared (:meth:`JitCache.clear`, :func:`clear_all`).
"""
from __future__ import annotations

import contextlib
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Hashable, Iterator, Sequence

import torch

#: what the programs did since the last :func:`reset_stats`: entries built
#: (``programs``, the CPU's plain entries included), graphs captured, graph
#: replays, and the seconds spent in warm-up calls and in captures
STATS = {"programs": 0, "graphs": 0, "replays": 0, "warmup_s": 0.0,
         "capture_s": 0.0}

_CACHES: "weakref.WeakSet[JitCache]" = weakref.WeakSet()
_DISABLED = [0]
_SIDE: dict = {}
_LEAVES = (torch.Tensor, type(None), bool, int, float, str)


class JitCache:
    """LRU cache keyed on anchor-object identity plus a hashable tail.

    ``anchors`` are the objects the cached program was built against
    (e.g. a task's parameter tree and config); they are held strongly
    for the lifetime of the entry.  ``key`` carries the hashable
    hyperparameters that also shape the program."""

    def __init__(self, maxsize: int = 16):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1; got {maxsize}")
        self.maxsize = maxsize
        self._entries: OrderedDict = OrderedDict()
        _CACHES.add(self)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    def get_or_build(self, anchors: Sequence[Any], key: Hashable,
                     build: Callable[[], Any]) -> Any:
        anchors = tuple(anchors)
        full_key = (tuple(id(a) for a in anchors), key)
        hit = self._entries.get(full_key)
        if hit is not None:
            value, kept = hit
            if len(kept) == len(anchors) and all(
                    k is a for k, a in zip(kept, anchors)):
                self._entries.move_to_end(full_key)
                return value
            # id collision against a dead anchor's slot: drop the stale entry
            del self._entries[full_key]
        value = build()
        self._entries[full_key] = (value, anchors)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
        return value


def clear_all() -> None:
    """Clear every live :class:`JitCache`: their anchors, static buffers
    and graph memory pools are released once nothing else holds them."""
    for cache in list(_CACHES):
        cache.clear()


def reset_stats() -> None:
    STATS.update(programs=0, graphs=0, replays=0, warmup_s=0.0,
                 capture_s=0.0)


@contextlib.contextmanager
def disable_jit() -> Iterator[None]:
    """While active, every function from :func:`jit` runs plain: no
    capture, no replay, no new cache entry (``jax.disable_jit``)."""
    _DISABLED[0] += 1
    try:
        yield
    finally:
        _DISABLED[0] -= 1


def jit_disabled() -> bool:
    return _DISABLED[0] > 0


# --------------------------------------------------------------- the trees

def _flatten(tree: Any, leaves: list) -> Any:
    """The structure of a nested dict / tuple / list tree, its leaves
    appended to ``leaves`` in order."""
    if type(tree) is dict:
        return ("dict", tuple((k, _flatten(v, leaves))
                              for k, v in tree.items()))
    if type(tree) in (tuple, list):
        return (type(tree).__name__, tuple(_flatten(v, leaves)
                                           for v in tree))
    if not isinstance(tree, _LEAVES):
        raise TypeError(f"a program's arguments and results are trees of "
                        f"dicts, tuples, lists, tensors and constants "
                        f"{_LEAVES}; got {type(tree).__name__}")
    leaves.append(tree)
    return None


def _unflatten(spec: Any, leaves: Iterator) -> Any:
    if spec is None:
        return next(leaves)
    kind, children = spec
    if kind == "dict":
        return {k: _unflatten(c, leaves) for k, c in children}
    seq = [_unflatten(c, leaves) for c in children]
    return tuple(seq) if kind == "tuple" else seq


def _leaf_sig(x: Any) -> Hashable:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device,
                x.data_ptr() % 16)
    return ("const", x)


def signature(args: tuple) -> Hashable:
    """What a program is built for: the tree structure of ``args`` and,
    per leaf, a tensor's shape, strides, dtype, device and base address
    modulo 16 bytes, or a constant's value."""
    leaves: list = []
    spec = _flatten(args, leaves)
    return spec, tuple(_leaf_sig(x) for x in leaves)


def _device(args: tuple) -> torch.device:
    leaves: list = []
    _flatten(args, leaves)
    devs = {x.device for x in leaves if isinstance(x, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"a program's inputs lie on one device; got "
                         f"{sorted(map(str, devs))}")
    return devs.pop() if devs else torch.device("cpu")


# ---------------------------------------------------------- launch counts

def _counters() -> list:
    """The kernel wrappers' launch and route counters."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6 import ops as wkv
    from repro_torch.kernels.tri_lora import ops as tl
    return [c for m in (da, fa, wkv, tl) for c in (m.LAUNCHES, m.ROUTES)]


def _restore(counters: list, saved: list) -> None:
    for c, s in zip(counters, saved):
        c.clear()
        c.update(s)


# ---------------------------------------------------------- the programs

def _static_like(t: torch.Tensor) -> torch.Tensor:
    """A buffer for input ``t``: its shape and strides, and its base
    address's offset modulo 16 bytes, so the kernels take the routes
    they take on ``t`` itself."""
    if any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape)):
        raise ValueError(f"an input of shape {tuple(t.shape)} with strides "
                         f"{t.stride()} overlaps itself: a program cannot "
                         f"copy it into a static buffer")
    es = t.element_size()
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride())) \
        if t.numel() else 0
    pad = 16 // es
    buf = torch.empty(span + pad, dtype=t.dtype, device=t.device)
    off = ((t.data_ptr() - buf.data_ptr()) % 16) // es
    return buf.as_strided(t.shape, t.stride(), off)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up stream a device, so warm-ups reuse its cached blocks."""
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


class GraphProgram:
    """``fn`` captured as a CUDA graph for the signature of ``args``
    (built here: warm-up, capture); calling it replays the graph."""

    def __init__(self, fn: Callable, args: tuple):
        self._sig = signature(args)
        leaves: list = []
        self._spec = _flatten(args, leaves)
        self._static = [_static_like(x) if isinstance(x, torch.Tensor)
                        else x for x in leaves]
        for s, x in zip(self._static, leaves):
            if isinstance(x, torch.Tensor):
                s.copy_(x)
        static_args = _unflatten(self._spec, iter(self._static))
        device = _device(args)
        counters = _counters()
        before = [dict(c) for c in counters]
        t0 = time.perf_counter()
        try:
            side = _side_stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                fn(*static_args)
            side.synchronize()
            _restore(counters, before)
            t1 = time.perf_counter()
            STATS["warmup_s"] += t1 - t0
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph,
                                  capture_error_mode="thread_local"):
                out = fn(*static_args)
            self._deltas = [{k: v - b.get(k, 0) for k, v in c.items()
                             if v != b.get(k, 0)}
                            for c, b in zip(counters, before)]
        finally:
            _restore(counters, before)
        self._out: list = []
        self._out_spec = _flatten(out, self._out)
        STATS["graphs"] += 1
        STATS["capture_s"] += time.perf_counter() - t1

    def __call__(self, *args: Any) -> Any:
        if signature(args) != self._sig:
            raise ValueError("the arguments' signature is not the one this "
                             "program was captured for")
        leaves: list = []
        _flatten(args, leaves)
        for s, x in zip(self._static, leaves):
            if isinstance(x, torch.Tensor):
                s.copy_(x)
        self._graph.replay()
        for c, d in zip(_counters(), self._deltas):
            for k, v in d.items():
                c[k] = c.get(k, 0) + v
        STATS["replays"] += 1
        return _unflatten(self._out_spec, iter(
            o.clone() if isinstance(o, torch.Tensor) else o
            for o in self._out))


def program(fn: Callable, args: tuple) -> Callable:
    """``fn`` as a program for the signature of ``args``: a captured CUDA
    graph when they lie on a CUDA device, ``fn`` itself on the CPU."""
    prog = GraphProgram(fn, args) if _device(args).type == "cuda" else fn
    STATS["programs"] += 1
    return prog


def jit(cache: JitCache, anchors: Sequence[Any], key: Hashable,
        fn: Callable) -> Callable:
    """``fn`` through ``cache``: each call runs the program built for
    (``anchors``, ``key``, the arguments' :func:`signature`), building it
    on a miss; under :func:`disable_jit`, ``fn`` itself."""
    anchors = tuple(anchors)

    def call(*args: Any) -> Any:
        if jit_disabled():
            return fn(*args)
        prog = cache.get_or_build(anchors, (key, signature(args)),
                                  lambda: program(fn, args))
        return prog(*args)
    return call
