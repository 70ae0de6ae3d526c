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
replay overwrites.

Donated arguments (``donate_argnums``, as in ``jax.jit``): the static
buffer of a donated tensor leaf is the caller's own tensor, as passed when
the program was built.  The warm-up and the capture read it and write it
in place (so a function may write a donated argument in place only where
running it twice on the same inputs gives the result of one run, as the
decode step's K/V write does: the same value to the same slot), and the
graph ends by copying the function's result for that argument into it.
That result is the element of the function's result (a tuple or a list)
with the argument's tree and leaf shapes and dtypes; it is returned as the
buffers themselves, in the argument's tree, not as clones.  A later call
that passes the very same tensor copies nothing; one that passes another
tensor of the signature has it copied in once, and the caller treats a
donated argument as consumed, as in JAX.  So a decode step's KV cache or
a scan chunk's carry is never duplicated.  Neither
:func:`repro_torch.core.client_batch.release` nor anything else frees a
live program's static buffers (:func:`static_storages`); :func:`unshared`
gives a result back its own storage before a program's next call reuses
it.  A caller that would allocate a new donated argument for a call asks
:func:`held` for the buffers a live program keeps and resets them
instead, so a second call at the same shapes neither holds two copies nor
captures again.  Under a warm-up or a capture every function from :func:`jit` runs
plain, as under :func:`disable_jit`: a program is never replayed inside
another's capture.  A replay runs no Python, so the kernel wrappers'
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
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Hashable, Iterator, Sequence

import torch

#: what the programs did since the last :func:`reset_stats`: entries built
#: (``programs``, the CPU's plain entries included), graphs captured, graph
#: replays, the seconds spent in warm-up calls and in captures, and the
#: donated leaves a call had to copy in (another tensor than the buffer)
STATS = {"programs": 0, "graphs": 0, "replays": 0, "warmup_s": 0.0,
         "capture_s": 0.0, "donated_in": 0}

_CACHES: "weakref.WeakSet[JitCache]" = weakref.WeakSet()
_PROGRAMS: "weakref.WeakSet[GraphProgram]" = weakref.WeakSet()
_DISABLED = [0]
_BUILDING = threading.local()         # this thread's depth of program builds
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
                 capture_s=0.0, donated_in=0)


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


def _building() -> int:
    return getattr(_BUILDING, "depth", 0)


@contextlib.contextmanager
def _build_scope() -> Iterator[None]:
    """A program's warm-up and capture: the functions from :func:`jit`
    that it calls run plain on this thread."""
    _BUILDING.depth = _building() + 1
    try:
        yield
    finally:
        _BUILDING.depth -= 1


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


def _paths(tree: Any, prefix: tuple = ()) -> dict:
    """{path: leaf} of a tree, a path naming each dict key and sequence
    index on the way down (dict order does not matter)."""
    if type(tree) is dict:
        out: dict = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (("key", k),)))
        return out
    if type(tree) in (tuple, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (("at", i),)))
        return out
    return {prefix: tree}


def _same_kind(a: Any, b: Any) -> bool:
    """Leaf ``b`` can be written into leaf ``a``: tensors of one shape and
    dtype, or equal constants."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype)
    return type(a) is type(b) and a == b


def _result_of(arg: Any, out: Any, argnum: int) -> int:
    """The index of the element of ``out`` that is the function's result
    for donated argument ``arg``: the one element with its paths and its
    leaves' shapes and dtypes."""
    if type(out) not in (tuple, list):
        raise TypeError(f"a program with donated arguments returns a tuple "
                        f"or a list; got {type(out).__name__}")
    want = _paths(arg)
    hits = [j for j, o in enumerate(out)
            if _paths(o).keys() == want.keys()
            and all(_same_kind(want[k], v) for k, v in _paths(o).items())]
    if len(hits) != 1:
        raise ValueError(f"donated argument {argnum}: {len(hits)} elements "
                         f"of the result have its tree, shapes and dtypes "
                         f"(need exactly one)")
    return hits[0]


def _overlaps(t: torch.Tensor) -> bool:
    return any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape))


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
    if _overlaps(t):
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
    (built here: warm-up, capture); calling it replays the graph.  The
    arguments ``donate_argnums`` are donated (module docstring)."""

    def __init__(self, fn: Callable, args: tuple,
                 donate_argnums: Sequence[int] = ()):
        self._sig = signature(args)
        donate = tuple(sorted(set(donate_argnums)))
        if any(not 0 <= i < len(args) for i in donate):
            raise ValueError(f"donate_argnums {donate_argnums} out of range "
                             f"for {len(args)} arguments")
        leaves: list = []
        specs, owner = [], []
        for i, a in enumerate(args):
            n = len(leaves)
            specs.append(_flatten(a, leaves))
            owner += [i] * (len(leaves) - n)
        self._spec = ("tuple", tuple(specs))
        # a donated tensor leaf's buffer is the caller's tensor itself
        self._given = [i in donate and isinstance(x, torch.Tensor)
                       for i, x in zip(owner, leaves)]
        for x, given in zip(leaves, self._given):
            if given and _overlaps(x):
                raise ValueError(f"a donated input of shape "
                                 f"{tuple(x.shape)} with strides "
                                 f"{x.stride()} overlaps itself: a program "
                                 f"cannot write it in place")
        self._static = [x if given else _static_like(x)
                        if isinstance(x, torch.Tensor) else x
                        for x, given in zip(leaves, self._given)]
        for s, x, given in zip(self._static, leaves, self._given):
            if isinstance(x, torch.Tensor) and not given:
                s.copy_(x)
        static_args = _unflatten(self._spec, iter(self._static))
        self._donated = {i: static_args[i] for i in donate}
        device = _device(args)
        counters = _counters()
        before = [dict(c) for c in counters]
        t0 = time.perf_counter()
        try:
            with _build_scope():
                side = _side_stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    warm = fn(*static_args)
                side.synchronize()
                # where each donated argument's result sits (checked here,
                # before the capture)
                results = {i: _result_of(static_args[i], warm, i)
                           for i in donate}
                del warm
                _restore(counters, before)
                t1 = time.perf_counter()
                STATS["warmup_s"] += t1 - t0
                self._graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self._graph,
                                      capture_error_mode="thread_local"):
                    out = fn(*static_args)
                    out = self._write_back(static_args, out, results)
            self._deltas = [{k: v - b.get(k, 0) for k, v in c.items()
                             if v != b.get(k, 0)}
                            for c, b in zip(counters, before)]
        finally:
            _restore(counters, before)
        self._out: list = []
        self._out_spec = _flatten(out, self._out)
        given = {id(s) for s, g in zip(self._static, self._given) if g}
        self._alias = [isinstance(o, torch.Tensor) and id(o) in given
                       for o in self._out]
        _PROGRAMS.add(self)
        STATS["graphs"] += 1
        STATS["capture_s"] += time.perf_counter() - t1

    @staticmethod
    def _write_back(static_args: tuple, out: Any, results: dict) -> Any:
        """Inside the capture: copy the result for each donated argument
        into its buffers (a leaf that already is its buffer needs none)
        and put the buffers, in the argument's tree, in its place."""
        if not results:
            return out
        pairs = []
        for i, j in results.items():
            want, got = _paths(static_args[i]), _paths(out[j])
            pairs += [(want[k], got[k]) for k in want
                      if isinstance(want[k], torch.Tensor)]
        mine = {d.untyped_storage().data_ptr() for d, _ in pairs}

        def same(a, b):
            return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                    and a.stride() == b.stride())
        # a result that reads some donated buffer is cloned first: the
        # copies below may overwrite what it reads
        pairs = [(d, o.clone() if o.untyped_storage().data_ptr() in mine
                  else o) for d, o in pairs if not same(d, o)]
        for d, o in pairs:
            d.copy_(o)
        ret = list(out)
        for i, j in results.items():
            ret[j] = static_args[i]
        return type(out)(ret)

    def __call__(self, *args: Any) -> Any:
        if signature(args) != self._sig:
            raise ValueError("the arguments' signature is not the one this "
                             "program was captured for")
        leaves: list = []
        _flatten(args, leaves)
        for s, x, given in zip(self._static, leaves, self._given):
            if not isinstance(x, torch.Tensor):
                continue
            if not given:
                s.copy_(x)
            elif x.data_ptr() != s.data_ptr():
                s.copy_(x)                # another tensor: copied in once
                STATS["donated_in"] += 1
        self._graph.replay()
        for c, d in zip(_counters(), self._deltas):
            for k, v in d.items():
                c[k] = c.get(k, 0) + v
        STATS["replays"] += 1
        return _unflatten(self._out_spec, iter(
            o if alias else o.clone() if isinstance(o, torch.Tensor) else o
            for o, alias in zip(self._out, self._alias)))


def static_storages() -> set:
    """The base addresses of the storages that live programs' static
    buffers lie in (donated ones included): memory a graph replays into."""
    return {s.untyped_storage().data_ptr() for p in list(_PROGRAMS)
            for s in p._static if isinstance(s, torch.Tensor)}


def unshared(tree: Any) -> Any:
    """``tree`` with every tensor that lies in a live program's static
    buffer replaced by a clone: a result the caller keeps past the
    program's next call (which may copy another donated argument in)."""
    held = static_storages()
    if not held:
        return tree
    leaves: list = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter(
        x.clone() if isinstance(x, torch.Tensor)
        and x.untyped_storage().data_ptr() in held else x for x in leaves))


def program(fn: Callable, args: tuple,
            donate_argnums: Sequence[int] = ()) -> Callable:
    """``fn`` as a program for the signature of ``args``: a captured CUDA
    graph when they lie on a CUDA device, ``fn`` itself on the CPU."""
    prog = (GraphProgram(fn, args, donate_argnums)
            if _device(args).type == "cuda" else fn)
    STATS["programs"] += 1
    return prog


def held(cache: JitCache, anchors: Sequence[Any], key: Hashable,
         argnum: int, like: Any) -> Any:
    """The buffers that a live program of ``jit(cache, anchors, key, fn,
    donate_argnums)`` holds for its donated argument ``argnum``, in their
    tree, where they have the tree, shapes and dtypes of ``like`` (which
    may lie on ``meta``); None if no such program lives, under
    :func:`disable_jit` and inside a build.  A caller passes them back,
    reset to the value it needs, instead of a new tensor: one copy of the
    argument, and the program's own signature."""
    if jit_disabled() or _building():
        return None
    ids = tuple(id(a) for a in anchors)
    want = _paths(like)
    for (kid, tail), (prog, kept) in reversed(cache._entries.items()):
        if (kid != ids or not isinstance(prog, GraphProgram)
                or tail[:1] != (key,) or argnum not in tail[1]
                or not all(k is a for k, a in zip(kept, anchors))):
            continue
        got = _paths(prog._donated[argnum])
        if got.keys() == want.keys() and all(
                _same_kind(want[k], v) for k, v in got.items()):
            return prog._donated[argnum]
    return None


def jit(cache: JitCache, anchors: Sequence[Any], key: Hashable,
        fn: Callable, donate_argnums: Sequence[int] = ()) -> Callable:
    """``fn`` through ``cache``: each call runs the program built for
    (``anchors``, ``key``, ``donate_argnums``, the arguments'
    :func:`signature`), building it on a miss; under :func:`disable_jit`
    or inside another program's warm-up or capture, ``fn`` itself."""
    anchors = tuple(anchors)
    donate = tuple(sorted(set(donate_argnums)))

    def call(*args: Any) -> Any:
        if jit_disabled() or _building():
            return fn(*args)
        prog = cache.get_or_build(anchors, (key, donate, signature(args)),
                                  lambda: program(fn, args, donate))
        return prog(*args)
    return call
