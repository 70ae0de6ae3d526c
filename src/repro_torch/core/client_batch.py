"""Batched-over-clients tree utilities (the vectorized federated runtime):
PyTorch port of the stacked-state half of ``repro.core.client_batch``.

The loop path keeps the m clients' states as a list of identically shaped
trees; the vectorized path keeps ONE tree whose every leaf carries a
leading client axis:

    list of m states, leaves (…)   ⇄   one state, leaves (m, …)

The strategies (:mod:`.baselines`) are tree algebra, so they run on a
stacked state unchanged; the model folds the clients' batches into one
batch whose sequences each apply their own client's adapter
(``models.model.forward_hidden``'s ``adapter_rows``).  The client axis is
always axis 0.

The scan engine (:mod:`.fed_engine`, the LM driver's scan path) feeds its
rounds in chunks: :func:`stack_chunk_batches` draws a chunk of rounds
(round-major, then client-minor, as the eager paths draw them) into host
tensors, pinned when the target is a card, so that the dispatch moves a
chunk with one ``non_blocking`` copy per tensor (:func:`to_device`);
:class:`ChunkPrefetcher` draws the next chunk on a thread while the
current one computes; :func:`drive_chunks` runs the chunks and, with
``donate``, releases the storage of each old carry (:func:`release`).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import jit_cache
from repro_torch.tree import tree_leaves, tree_map


def stack_states(states: Sequence[Any]) -> Any:
    """m identically structured trees → one tree with leaves (m, …)."""
    return tree_map(lambda *xs: torch.stack(xs), states[0], *states[1:])


def n_clients(stacked: Any) -> int:
    """Extent of the leading client axis."""
    return int(tree_leaves(stacked)[0].shape[0])


def client_state(stacked: Any, i: int) -> Any:
    """Client i's slice of a stacked tree (views)."""
    return tree_map(lambda t: t[i], stacked)


def unstack_states(stacked: Any) -> list:
    """Inverse of :func:`stack_states` (m per-client trees, views)."""
    return [client_state(stacked, i) for i in range(n_clients(stacked))]


def _rows_mask(mask: Any, like: torch.Tensor) -> torch.Tensor:
    """A boolean (m,) mask on ``like``'s device, shaped to broadcast over
    its trailing axes."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=like.device)
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def select_clients(mask: Any, new: Any, old: Any) -> Any:
    """Per-client select over the leading axis: client i's leaves come from
    ``new`` where ``mask[i]``, else from ``old`` — the masked install of
    partial participation (unsampled clients keep their state).  ``mask``
    is boolean (m,)."""
    return tree_map(lambda n_, o_: torch.where(_rows_mask(mask, n_), n_, o_),
                    new, old)


def id_mask(m: int, ids: torch.Tensor,
            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The boolean (m,) mask holding ``rows`` (default all True) at the
    unique client ids ``ids`` and False elsewhere, on ``ids``' device: a
    cohort's or a buffer's rows as an all-m mask."""
    if rows is None:
        rows = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    return torch.zeros(m, dtype=torch.bool, device=ids.device).index_copy(
        0, ids, rows)


def gather_clients(stacked: Any, ids: Any) -> Any:
    """Rows ``ids`` of a stacked tree: leaves (m, …) → (k, …)."""
    def take(t):
        return t[torch.as_tensor(ids, dtype=torch.long, device=t.device)]
    return tree_map(take, stacked)


def scatter_clients(stacked: Any, ids: Any, values: Any) -> Any:
    """Functional inverse of :func:`gather_clients`: a new tree with rows
    ``ids`` of ``stacked`` (leaves (m, …)) replaced by ``values`` (leaves
    (k, …)); ``ids`` must be unique."""
    def put(t, v):
        idx = torch.as_tensor(ids, dtype=torch.long, device=t.device)
        return t.index_copy(0, idx, v.to(t.dtype))
    return tree_map(put, stacked, values)


def broadcast_to_clients(tree: Any, m: int) -> Any:
    """Replicate one (global) tree over the client axis: leaves (…) →
    (m, …) — used to install a FedAvg downlink into a stacked state."""
    return tree_map(lambda t: t[None].expand((m,) + tuple(t.shape))
                    .contiguous(), tree)


def stack_client_batches(loaders: Sequence, n_batches: int, *,
                         device) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``n_batches`` minibatches from each client's loader and collate
    them into ``(m, n_batches, B, T)`` tokens and ``(m, n_batches, B)``
    labels on ``device``.  The draws come from the same per-client streams
    as the loop path's, so both paths see the same data."""
    toks, labs = [], []
    for ld in loaders:
        bt = list(ld.batches(n_batches))
        toks.append(np.stack([b["tokens"] for b in bt]))
        labs.append(np.stack([b["labels"] for b in bt]))
    return (torch.as_tensor(np.stack(toks), device=device),
            torch.as_tensor(np.stack(labs), device=device))


# ---------------------------------------------------------------------------
# the scan engine's chunk feeders
# ---------------------------------------------------------------------------

def host_tensor(a, device) -> torch.Tensor:
    """A numpy array or CPU tensor as a CPU tensor, pinned when ``device``
    is a card, so that :func:`to_device` copies it without a host sync."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def to_device(tree: Any, device) -> Any:
    """Every host tensor of ``tree`` on ``device`` by one ``non_blocking``
    copy each (asynchronous from pinned memory; a no-op on the CPU)."""
    return tree_map(lambda t: t.to(device, non_blocking=True), tree)


def _collate(draws: list) -> tuple[np.ndarray, np.ndarray]:
    return (np.stack([b["tokens"] for b in draws]),
            np.stack([b["labels"] for b in draws]))


def stack_cohort_batches(loaders: Sequence, ids, n_batches: int, *,
                         device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """One round's batches for the COHORT only: ``(k, n_batches, B, T)``
    tokens and ``(k, n_batches, B)`` labels of the clients in ``ids``
    (ascending, the cohort order of
    :class:`.sampling.ParticipationPlan`), as host tensors (pinned for a
    card).  Every other client's loader skips its draws
    (:meth:`repro_torch.data.pipeline.Loader.skip`), so the per-client
    streams stay those of :func:`stack_client_batches`."""
    sel = {int(i) for i in np.asarray(ids)}
    toks, labs = [], []
    for i, ld in enumerate(loaders):
        if i not in sel:
            ld.skip(n_batches)
            continue
        t, l = _collate(list(ld.batches(n_batches)))
        toks.append(t)
        labs.append(l)
    return (host_tensor(np.stack(toks), device),
            host_tensor(np.stack(labs), device))


def stack_chunk_batches(loaders: Sequence, n_rounds: int, n_batches: int, *,
                        device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """A CHUNK of rounds for the scan engine: ``(n_rounds, m, n_batches, B,
    T)`` tokens and ``(n_rounds, m, n_batches, B)`` labels as host tensors
    (pinned for a card).  The draws go round-major, then client-minor —
    ``n_rounds`` successive :func:`stack_client_batches` draws — so the
    per-client streams stay aligned with the eager paths."""
    tk, lb = [], []
    for _ in range(n_rounds):
        rt, rl = [], []
        for ld in loaders:
            t, l = _collate(list(ld.batches(n_batches)))
            rt.append(t)
            rl.append(l)
        tk.append(np.stack(rt))
        lb.append(np.stack(rl))
    return (host_tensor(np.stack(tk), device),
            host_tensor(np.stack(lb), device))


class ChunkPrefetcher:
    """Double-buffered chunk producer of the scan engine: a thread draws and
    stacks chunk c+1's batches (``produce(n_rounds)``) while chunk c
    computes, in ``schedule`` order (the chunk sizes), so the batches are
    bit for bit what calling ``produce`` in turn would give.  The queue is
    bounded (``depth``, default 2): the producer stays at most ``depth``
    chunks ahead.  ``get()`` returns ``(payload, produce_seconds)`` and
    re-raises the producer's exceptions; after :meth:`close` it raises.
    Call ``close()`` on an early exit so that the thread stops drawing."""

    _DONE = object()

    def __init__(self, produce: Callable[[int], Any],
                 schedule: Sequence[int], depth: int = 2):
        assert depth >= 1, depth
        self._produce = produce
        self._schedule = list(schedule)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chunk-prefetcher")
        self._thread.start()

    def _run(self) -> None:
        try:
            for n_rounds in self._schedule:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                item = self._produce(n_rounds)
                self._put((item, time.perf_counter() - t0))
            self._put(self._DONE)
        except BaseException as e:  # re-raised in the consumer's get()
            self._put(e)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def get(self):
        """The next chunk's ``(payload, produce_seconds)``, in schedule
        order; blocks until the producer has it.  Raises ``StopIteration``
        past the schedule's end and ``RuntimeError`` after :meth:`close`
        (the queue is never fed again)."""
        if self._closed:
            raise RuntimeError(
                "ChunkPrefetcher.get() after close(): the producer is "
                "stopped and the queue will never be fed again")
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration("prefetch schedule exhausted")
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        """Stop the producer; safe to call more than once.  Drains the
        queue again and again until the thread exits: a producer blocked in
        ``_put`` may complete its put into the slot one drain freed."""
        self._closed = True
        self._stop.set()
        deadline = time.perf_counter() + 5.0
        while True:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
            if not self._thread.is_alive() or time.perf_counter() > deadline:
                break


class ReleasedTensor(torch.Tensor):
    """The class a tensor takes when :func:`release` frees its storage:
    every operation on it raises.  (A tensor whose storage is merely
    resized to zero would read freed memory instead.)"""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(
            f"{getattr(func, '__name__', func)}: this tensor belonged to a "
            f"donated scan carry and was released after its chunk")


def release(old: Any, new: Any) -> int:
    """Free the storage of every tensor of ``old`` that ``new`` does not
    share, and make any later operation on such a tensor raise — the
    port's form of deleting a donated carry.  A tensor of ``new`` may BE a
    tensor of ``old`` (a leaf the chunk did not change, such as a frozen
    factor) or a view of one: those storages are kept.  A storage that a
    numpy array still views (a CPU tensor read by ``.numpy()``, as a
    checkpoint save reads it) cannot be resized: its tensors are made to
    raise all the same, and the bytes go with the array.  A storage that a
    live program replays into (:func:`.jit_cache.static_storages`: a
    donated carry is the chunk program's buffer) is kept as it is.
    Returns the number of storages freed."""
    keep = {t.untyped_storage().data_ptr() for t in tree_leaves(new)
            if isinstance(t, torch.Tensor)
            and not isinstance(t, ReleasedTensor)}
    keep |= jit_cache.static_storages()
    freed = 0
    for t in tree_leaves(old):
        if not isinstance(t, torch.Tensor) or isinstance(t, ReleasedTensor):
            continue
        st = t.untyped_storage()
        if st.nbytes() and st.data_ptr() in keep:
            continue
        if st.nbytes() and st.resizable():
            st.resize_(0)
            freed += 1
        t.__class__ = ReleasedTensor
    return freed


def drive_chunks(carry: Any, schedule: Sequence[tuple[int, int]],
                 produce: Callable[[int], Any], dispatch: Callable,
                 on_chunk: Callable, *, donate: bool = True,
                 prefetch: bool = True) -> Any:
    """The chunk driver of both scan engines: for each ``(c0, c1)`` of
    ``schedule`` fetch the chunk's batches (from a :class:`ChunkPrefetcher`
    with ``prefetch``, else ``produce(c1 - c0)`` inline), run ``dispatch(
    carry, batches, c0, c1) → (new_carry, host_outputs)`` (which reads its
    outputs back, so that the device time lands here) and, with
    ``donate``, :func:`release` the old carry.

    ``on_chunk(carry, c0, c1, out, host_s, device_s, wall_s)`` gets the new
    carry and the per-ROUND wall split: ``host_s`` the time spent waiting
    for the batches (the residual wait under prefetch), ``device_s`` the
    dispatch and its read-back.  The prefetcher is closed on any exit.
    Returns the final carry."""
    prefetcher = None
    if prefetch and schedule:
        prefetcher = ChunkPrefetcher(produce,
                                     [c1 - c0 for c0, c1 in schedule])
    try:
        for c0, c1 in schedule:
            t0 = time.perf_counter()
            if prefetcher is not None:
                batches, _produce_s = prefetcher.get()
            else:
                batches = produce(c1 - c0)
            t_fetch = time.perf_counter()
            prev_carry = carry
            carry, out = dispatch(carry, batches, c0, c1)
            if donate:
                release(prev_carry, carry)
            t_done = time.perf_counter()
            n_r = c1 - c0
            on_chunk(carry, c0, c1, out, (t_fetch - t0) / n_r,
                     (t_done - t_fetch) / n_r, (t_done - t0) / n_r)
    finally:
        if prefetcher is not None:
            prefetcher.close()
    return carry
