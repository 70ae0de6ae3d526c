"""The asynchronous buffered engine, ``FedConfig.engine="async"``: PyTorch
port of ``repro.core.async_engine``.

The synchronous engines advance in lockstep rounds: the server waits for
the whole cohort before aggregating.  This engine replaces the barrier by
a FedBuff-style buffered server:

* **Dispatch** — clients get work in plan order (the same
  :mod:`.sampling` plans the sync engines read, wave-major, client-minor),
  at most ``FedConfig.async_concurrency`` in flight at once.  A client
  never holds two assignments: its wave-t+1 item waits (FIFO) until its
  wave-t upload has been flushed.
* **Arrival** — each dispatch draws a virtual-time latency from the seeded
  :class:`.sampling.LatencyModel`; arrivals replay from a min-heap keyed
  ``(arrival_time, dispatch_seq)``, so the interleaving is a function of
  ``(seed, config)`` alone: no threads, no wall clock.
* **Flush** — every ``FedConfig.buffer_size`` (K) arrivals the server
  aggregates the buffered uploads into the current state, each discounted
  by ``staleness_decay ** staleness`` (staleness: the flushes since the
  contribution was dispatched) — a column scale of the eqn-(3) weights
  before the row normalization, or of FedAvg's counts.  One flush is one
  ``RoundRecord``.

Equivalence contract (the JAX package's): in the zero-staleness limit —
uniform latency, ``buffer_size`` = cohort size — a whole wave arrives at
one instant, every flush is one sync round, and the history is the sync
engines'.  Under partial participation that holds for the uncompressed
wire only: the sync engines re-quantize all m rows every round for the
CKA refresh, while this engine quantizes only what a client uploads.

A fit group (the records dispatched at one instant, 1…k clients) runs the
vectorized path's stacked local fit (the grouped tri-LoRA kernels on a
card), and each record's uplink is encoded with the uniforms of its
``(wave, client)`` — the sync engines' ``(round, client)`` stream, the
record's wave being its sync round.  Error feedback advances at encode
time inside the client's own dispatch; a rejected or dropped upload rolls
it back.

Faults (``fault_*``, ``admission="norm"``, ``dispatch_timeout``): a
dispatch rolls the seeded per-(wave, client, attempt) fault draw
(:meth:`.faults.FaultModel.draw_one`); a crash re-queues the same wave, a
lost or timed-out upload re-sends after ``retry_backoff · 2^attempt`` with
a fresh latency, up to ``retry_cap``, then drops.  Every transmission is
priced.

Checkpoint and resume: at flush boundaries (``chunk_rounds`` cadence) the
stacked client states, S^model, the history, the per-client data-stream
positions, the virtual clock and the in-flight records (their encoded
uploads included) are written in the JAX package's tree keys and metadata,
so a checkpoint of either package resumes in the other; the heap is
rebuilt from the stored float64 arrival times and the resumed run replays
the identical event sequence.
"""
from __future__ import annotations

import dataclasses
import heapq
import os
import time
import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import (admission, aggregation, client_batch,
                              client_store, compress, faults, sampling,
                              tri_lora)
from repro_torch.core.fed_engine import (ROBUSTNESS_DEFAULTS, _fingerprint,
                                         meta_like)
from repro_torch.core.similarity import cka
from repro_torch.tree import tree_map


def async_fingerprint(fed, buffer_size: int, concurrency: int) -> dict:
    """The scan fingerprint plus the async knobs, resolved (so that ``0``
    and an explicit cohort size interchange)."""
    return dict(_fingerprint(fed), buffer_size=buffer_size,
                async_concurrency=concurrency,
                staleness_decay=fed.staleness_decay, latency=fed.latency,
                latency_scale=fed.latency_scale,
                latency_sigma=fed.latency_sigma,
                dispatch_timeout=fed.dispatch_timeout,
                retry_backoff=fed.retry_backoff, retry_cap=fed.retry_cap)


@dataclasses.dataclass
class Arrival:
    """One dispatched local-fit assignment in flight (host bookkeeping)."""
    seq: int          # global dispatch sequence number (heap tie-break)
    client: int
    wave: int         # plan wave = the client's data-stream session index
    version: int      # aggregate version served at dispatch (staleness base)
    arrival: float    # virtual arrival time
    loss: float = 0.0
    upload: Any = None  # served (dequantized) uplink rows, filled at fit
    attempt: int = 0    # re-dispatch count for this (wave, client)
    failed: str = ""    # "" clean | "crash" (died mid-fit) | "retry" (lost
                        # in transit or timed out: re-send the same upload)
    tx: int = 0         # uplink transmissions charged to this record so far
    ef_prev: Any = None  # pre-fit EF residual rows (rollback on reject/drop)


class AsyncScheduler:
    """The deterministic virtual-time event loop (pure host bookkeeping),
    the JAX package's scheduler line for line.

    ``fit_group(records)`` is called at dispatch time and must fill each
    record's ``loss`` / ``upload``; ``flush_cb(records, flush_idx,
    sim_now)`` is called once per flush AFTER the scheduler has advanced
    (version bumped, contributors freed), so a checkpoint written inside
    the callback holds exactly the state a resumed run must re-enter.
    """

    def __init__(self, *, waves: Sequence[np.ndarray], m: int,
                 latency: sampling.LatencyModel, seed: int,
                 buffer_size: int, concurrency: int, rounds: int,
                 fit_group: Callable, flush_cb: Callable,
                 timeout: float = 0.0, backoff: float = 1.0,
                 retry_cap: int = 3, fail_of: Optional[Callable] = None,
                 on_drop: Optional[Callable] = None):
        self.waves = waves
        self.m = m
        self.latency = latency
        self.seed = seed
        self.buffer_size = buffer_size
        self.concurrency = concurrency
        self.rounds = rounds
        self.fit_group = fit_group
        self.flush_cb = flush_cb
        # faults (the defaults are the fault-free scheduler exactly):
        # fail_of(wave, client, attempt) -> (crash, loss) rolls the seeded
        # draw at dispatch; timeout > 0 abandons any upload slower than it;
        # abandoned or lost sends re-dispatch after backoff·2^attempt until
        # retry_cap, then drop for good (on_drop(rec) is told)
        self.timeout = float(timeout)
        self.backoff = float(backoff)
        self.retry_cap = int(retry_cap)
        self.fail_of = fail_of
        self.on_drop = on_drop
        self._attempts: dict = {}       # (wave, client) -> crash re-dispatches
        self.orphan_tx = 0              # priced sends of dropped records
        self.n_dropped = 0

        self.heap: list = []            # (arrival, seq)
        self.by_seq: dict = {}          # seq -> Arrival (un-flushed records)
        self.buffer: list = []          # arrived, awaiting flush
        self.deferred: list = []        # (wave, client) FIFO, client was busy
        self._deferred_clients: dict = {}   # client -> #items in deferred
        self.busy: set = set()          # clients with an un-flushed record
        self.in_flight = 0              # dispatched, not yet arrived
        self.wc = 0                     # stream cursor: wave index
        self.wi = 0                     # stream cursor: index inside wave
        self.sim_now = 0.0
        self.next_seq = 0
        self.version = 0                # completed flushes

        self._lat_cache: dict = {}

    # ------------------------------------------------------------- dispatch
    def _latency_of(self, wave: int, client: int) -> float:
        if wave not in self._lat_cache:
            self._lat_cache[wave] = self.latency.draw(self.m, wave, self.seed)
        return float(self._lat_cache[wave][client])

    def _pop_dispatchable(self) -> Optional[tuple]:
        """The next (wave, client) to dispatch: the oldest deferred item
        whose client is free, else the next stream item — deferring stream
        items whose client is busy OR already has an earlier item deferred
        (a client's wave order must never invert)."""
        for idx, (w, c) in enumerate(self.deferred):
            if c not in self.busy:
                self.deferred.pop(idx)
                n = self._deferred_clients[c] - 1
                if n:
                    self._deferred_clients[c] = n
                else:
                    del self._deferred_clients[c]
                return (w, c)
        while self.wc < len(self.waves):
            wave = self.waves[self.wc]
            if self.wi >= len(wave):
                self.wc += 1
                self.wi = 0
                continue
            c = int(wave[self.wi])
            w = self.wc
            self.wi += 1
            if c in self.busy or c in self._deferred_clients:
                self.deferred.append((w, c))
                self._deferred_clients[c] = \
                    self._deferred_clients.get(c, 0) + 1
                continue
            return (w, c)
        return None

    def _refill(self) -> None:
        group = []
        while self.in_flight + len(group) < self.concurrency:
            item = self._pop_dispatchable()
            if item is None:
                break
            group.append(item)
            self.busy.add(item[1])   # so its next wave defers, not re-pops
        if group:
            self._dispatch(group)

    def _outcome(self, w: int, c: int, attempt: int, base: float) -> Arrival:
        """One Arrival departing at virtual time ``base``: roll the seeded
        fault draw and the latency (a retry re-keys by its attempt), then
        classify — clean, crash (nothing sent; the server notices at the
        timeout, or after the would-be latency when none is set), or retry
        (the bytes left the device but never land)."""
        crash = loss = False
        if self.fail_of is not None:
            crash, loss = self.fail_of(w, c, attempt)
        lat = (self._latency_of(w, c) if attempt == 0
               else self.latency.draw_retry(w, c, attempt, self.seed))
        rec = Arrival(seq=self.next_seq, client=c, wave=w,
                      version=self.version, arrival=base + lat,
                      attempt=attempt)
        self.next_seq += 1
        wait = self.timeout if self.timeout > 0 else lat
        if crash:
            rec.failed = "crash"
            rec.arrival = base + wait
        elif loss or (self.timeout > 0 and lat > self.timeout):
            rec.failed = "retry"
            rec.tx = 1
            rec.arrival = base + wait
        else:
            rec.tx = 1
        return rec

    def _dispatch(self, items: list) -> None:
        recs = []
        for w, c in items:
            rec = self._outcome(w, c, self._attempts.get((w, c), 0),
                                self.sim_now)
            self.in_flight += 1
            self.by_seq[rec.seq] = rec
            heapq.heappush(self.heap, (rec.arrival, rec.seq))
            recs.append(rec)
        # crashed clients died mid-fit: they neither train nor consume
        # their data-stream session (the re-dispatch refits it)
        live = [r for r in recs if r.failed != "crash"]
        if live:
            self.fit_group(live)

    def _drop(self, rec: Arrival) -> None:
        self.busy.discard(rec.client)
        self.orphan_tx += rec.tx
        self.n_dropped += 1
        if self.on_drop is not None:
            self.on_drop(rec)

    def _requeue_crash(self, rec: Arrival) -> None:
        """Free the crashed client and re-queue the SAME wave at the head
        of its deferral stream (its later waves stay behind it); past
        retry_cap the wave is abandoned instead."""
        self.in_flight -= 1
        del self.by_seq[rec.seq]
        if rec.attempt + 1 > self.retry_cap:
            self._drop(rec)
            return
        self.busy.discard(rec.client)
        self._attempts[(rec.wave, rec.client)] = rec.attempt + 1
        pos = next((i for i, (_, c) in enumerate(self.deferred)
                    if c == rec.client), len(self.deferred))
        self.deferred.insert(pos, (rec.wave, rec.client))
        self._deferred_clients[rec.client] = \
            self._deferred_clients.get(rec.client, 0) + 1

    def _retry(self, rec: Arrival) -> None:
        """Re-send an upload the server never received: exponential backoff
        on the virtual clock, a fresh latency and fault roll keyed by the
        new attempt, the already-fitted upload carried over (the client
        does not retrain); past retry_cap the record drops."""
        self.in_flight -= 1
        del self.by_seq[rec.seq]
        if rec.attempt + 1 > self.retry_cap:
            self._drop(rec)
            return
        base = self.sim_now + self.backoff * (2.0 ** rec.attempt)
        nxt = self._outcome(rec.wave, rec.client, rec.attempt + 1, base)
        if nxt.failed == "crash":
            # the fit already happened: a crash during a re-send is another
            # failed transmission (and prices no bytes)
            nxt.failed = "retry"
        nxt.loss, nxt.upload, nxt.ef_prev = rec.loss, rec.upload, rec.ef_prev
        nxt.version = rec.version       # staleness counts from the ORIGINAL
        nxt.tx += rec.tx                # dispatch, where the fit happened
        self.in_flight += 1
        self.by_seq[nxt.seq] = nxt
        heapq.heappush(self.heap, (nxt.arrival, nxt.seq))

    # ---------------------------------------------------------------- flush
    def _do_flush(self) -> None:
        records, self.buffer = self.buffer, []
        f = self.version
        for r in records:
            self.busy.discard(r.client)
            del self.by_seq[r.seq]
        self.version = f + 1
        self.flush_cb(records, f, self.sim_now)

    def run(self) -> None:
        if self.version >= self.rounds:
            return
        self._refill()
        while self.version < self.rounds:
            if not self.heap:
                if self.buffer:
                    # starvation flush: the plan stream is exhausted and the
                    # only undispatched records belong to clients parked in
                    # this very buffer — flush short to free them
                    self._do_flush()
                    if self.version >= self.rounds:
                        return
                    self._refill()
                    continue
                raise RuntimeError(
                    f"async engine deadlock: {self.version}/{self.rounds} "
                    f"flushes done, buffer {len(self.buffer)}/"
                    f"{self.buffer_size}, nothing in flight — the plan "
                    f"stream cannot supply buffer_size more uploads "
                    f"(buffer_size must be <= cohort size)")
            t = self.heap[0][0]
            self.sim_now = t
            group = []
            while self.heap and self.heap[0][0] == t:
                _, seq = heapq.heappop(self.heap)
                group.append(self.by_seq[seq])
            for rec in group:
                if rec.failed == "crash":
                    self._requeue_crash(rec)
                    continue
                if rec.failed == "retry":
                    self._retry(rec)
                    continue
                self.in_flight -= 1
                self.buffer.append(rec)
                if len(self.buffer) == self.buffer_size:
                    self._do_flush()
                    if self.version >= self.rounds:
                        return
                    # refill IMMEDIATELY: freed clients' next dispatch must
                    # see the just-flushed aggregate (and a resumed run's
                    # first refill replays exactly this one)
                    self._refill()
            self._refill()


# ---------------------------------------------------------------------------
# checkpoint plumbing
# ---------------------------------------------------------------------------

_FCODE = {"": 0, "crash": 1, "retry": 2}
_FNAME = {v: k for k, v in _FCODE.items()}


def _stack_rows(rows: list) -> Any:
    """Per-record trees of rows → one stacked tree (zeros where a record
    has none: a crashed record never fitted)."""
    tmpl = next((r for r in rows if r is not None), None)
    if tmpl is None:
        return None
    zed = tree_map(torch.zeros_like, tmpl)
    return tree_map(lambda *xs: torch.stack(xs),
                    *[r if r is not None else zed for r in rows])


def _save_async(fed, sched: AsyncScheduler, stacked, s_model, hist, consumed,
                fingerprint: dict, has_payload: bool, strategy,
                adm_state=None, track: bool = False,
                track_ef: bool = False) -> None:
    assert not sched.buffer, "checkpoints are written at flush boundaries"
    tree = {"state": stacked,
            "loss": np.asarray(hist["loss"], np.float64),
            "accs": np.asarray(hist["accs"], np.float32),
            "wall": np.asarray(hist["wall"], np.float32),
            "sim": np.asarray(hist["sim"], np.float64),
            "stale": np.asarray(hist["stale"], np.float64),
            "pids": np.asarray(hist["ids"], np.int32),
            "consumed": np.asarray(consumed, np.int64)}
    if s_model is not None:
        tree["s_model"] = s_model
    if adm_state is not None:
        tree["admission"] = adm_state
    rejv = failv = []
    if track:
        rejv = [i for row in hist["rej"] for i in row]
        failv = [i for row in hist["fail"] for i in row]
        tree["robust"] = {
            "tx": np.asarray(hist["tx"], np.int64),
            "nacc": np.asarray(hist["nacc"], np.int64),
            "rejc": np.asarray([len(r) for r in hist["rej"]], np.int32),
            "rejv": np.asarray(rejv, np.int32),
            "failc": np.asarray([len(r) for r in hist["fail"]], np.int32),
            "failv": np.asarray(failv, np.int32)}
    pending = sorted(sched.by_seq.values(), key=lambda r: r.seq)
    if pending:
        tree["pending"] = {
            "seq": np.asarray([r.seq for r in pending], np.int64),
            "client": np.asarray([r.client for r in pending], np.int32),
            "wave": np.asarray([r.wave for r in pending], np.int32),
            "version": np.asarray([r.version for r in pending], np.int64),
            "arrival": np.asarray([r.arrival for r in pending], np.float64),
            "loss": np.asarray([r.loss for r in pending], np.float32)}
        if track:
            tree["pending"]["attempt"] = np.asarray(
                [r.attempt for r in pending], np.int32)
            tree["pending"]["fcode"] = np.asarray(
                [_FCODE[r.failed] for r in pending], np.int32)
            tree["pending"]["tx"] = np.asarray(
                [r.tx for r in pending], np.int64)
        if has_payload:
            # crashed records never fitted: zero rows there (never read — a
            # crash re-queues through the deferral path, it does not flush)
            served = _stack_rows([r.upload for r in pending])
            if served is not None:
                tree["pending_served"] = served
        if track_ef:
            ef = _stack_rows([r.ef_prev for r in pending])
            if ef is not None:
                tree["pending_ef"] = ef
    if sched._attempts:
        keys = sorted(sched._attempts)
        tree["attempts"] = {
            "wave": np.asarray([w for w, _ in keys], np.int32),
            "client": np.asarray([c for _, c in keys], np.int32),
            "n": np.asarray([sched._attempts[k] for k in keys], np.int32)}
    if sched.deferred:
        tree["deferred"] = {
            "wave": np.asarray([w for w, _ in sched.deferred], np.int32),
            "client": np.asarray([c for _, c in sched.deferred], np.int32)}
    ckpt.save(fed.checkpoint_path, tree, metadata=dict(
        fingerprint, engine="async", strategy=strategy.name,
        rounds_done=sched.version, sim_now=sched.sim_now,
        next_seq=sched.next_seq, wc=sched.wc, wi=sched.wi,
        n_pending=len(pending), n_deferred=len(sched.deferred),
        track=track, has_admission=adm_state is not None,
        has_pending_served="pending_served" in tree,
        has_pending_ef="pending_ef" in tree,
        n_attempts=len(sched._attempts), n_rejv=len(rejv),
        n_failv=len(failv), orphan_tx=sched.orphan_tx,
        n_dropped=sched.n_dropped))


def _numpy_tree(tree: dict) -> dict:
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _load_async(fed, stacked, s_model, m: int, fingerprint: dict,
                payload_struct, has_payload: bool, device):
    """Restore a flush-boundary checkpoint: (stacked, s_model, history
    arrays, pending table, served rows, deferred table, meta), the state
    and the served rows on ``device``, the tables as numpy (the float64
    clock and loss tables stay float64)."""
    meta = ckpt.metadata(fed.checkpoint_path)
    if meta.get("engine") != "async" or "rounds_done" not in meta:
        raise ValueError(f"{fed.checkpoint_path!r} is not an async-engine "
                         f"checkpoint")
    ckpt.check_fingerprint(
        fed.checkpoint_path, meta, fingerprint,
        defaults=dict({"attn_impl": "auto", "dispatch_timeout": 0.0,
                       "retry_backoff": 1.0, "retry_cap": 3},
                      **ROBUSTNESS_DEFAULTS),
        ignore=("rounds",))
    done = int(meta["rounds_done"])
    if done > fed.rounds:
        raise ValueError(f"checkpoint has {done} completed flushes but the "
                         f"run asks for only {fed.rounds}")
    k_buf = int(fingerprint["buffer_size"])
    like = {"state": stacked,
            "loss": np.zeros((done,), np.float64),
            "accs": np.zeros((done, m), np.float32),
            "wall": np.zeros((done,), np.float32),
            "sim": np.zeros((done,), np.float64),
            "stale": np.zeros((done,), np.float64),
            "pids": np.zeros((done, k_buf), np.int32),
            "consumed": np.zeros((m,), np.int64)}
    if s_model is not None:
        like["s_model"] = s_model
    if meta.get("track", False):
        like["robust"] = {
            "tx": np.zeros((done,), np.int64),
            "nacc": np.zeros((done,), np.int64),
            "rejc": np.zeros((done,), np.int32),
            "rejv": np.zeros((int(meta.get("n_rejv", 0)),), np.int32),
            "failc": np.zeros((done,), np.int32),
            "failv": np.zeros((int(meta.get("n_failv", 0)),), np.int32)}
    n_pend = int(meta.get("n_pending", 0))

    def rows_like(dtype=None):
        return tree_map(lambda s: torch.empty(
            (n_pend,) + tuple(s.shape[1:]), dtype=dtype or s.dtype,
            device=device), payload_struct)
    if n_pend and has_payload and meta.get("has_pending_served", True):
        like["pending_served"] = rows_like()
    if n_pend and meta.get("has_pending_ef", False):
        like["pending_ef"] = rows_like(torch.float32)
    tree = ckpt.restore(fed.checkpoint_path, like)
    pending = (_numpy_tree(ckpt.load_subtree(fed.checkpoint_path, "pending"))
               if n_pend else {})
    deferred = (_numpy_tree(ckpt.load_subtree(fed.checkpoint_path,
                                              "deferred"))
                if int(meta.get("n_deferred", 0)) else {})
    if meta.get("has_admission", False):
        tree["admission"] = tree_map(
            lambda t: t.to(device),
            ckpt.load_subtree(fed.checkpoint_path, "admission"))
    if int(meta.get("n_attempts", 0)):
        tree["attempts"] = _numpy_tree(
            ckpt.load_subtree(fed.checkpoint_path, "attempts"))
    return (tree["state"], tree.get("s_model"), tree, pending,
            tree.get("pending_served"), deferred, meta)


# ---------------------------------------------------------------------------
# engine body
# ---------------------------------------------------------------------------

def run_async(*, task, fed, strategy, states: list, loaders: Sequence,
              sample_counts: Sequence[int],
              plans: Sequence[sampling.ParticipationPlan],
              local_fit: Callable, eval_acc: Callable,
              s_data: Optional[torch.Tensor],
              test_toks: torch.Tensor, test_labs: torch.Tensor,
              cka_probes: Optional[torch.Tensor],
              sr_uniforms: Optional[Callable], device,
              verbose: bool = False) -> dict:
    """The async-engine body of ``run_federated`` (module docstring).
    ``fed.rounds`` counts FLUSHES; the plans supply the dispatch stream
    (``rounds`` waves of the sync cohort size k >= buffer_size).
    ``local_fit`` / ``eval_acc`` are the vectorized path's stacked fit and
    eval; ``sr_uniforms(wave, client)`` the codec's uniform source.
    Returns ``run_federated``'s result dict plus ``sim_times``,
    ``staleness_mean`` and ``fit_groups`` (the size of every fit group, in
    dispatch order)."""
    from repro_torch.core.federated import RoundRecord   # late: a cycle

    dev = torch.device(device)
    m = fed.n_clients
    mode = fed.client_parallelism
    k = int(plans[0].sampled.size)
    K = int(fed.buffer_size) if fed.buffer_size else k
    if not 1 <= K <= k:
        raise ValueError(f"buffer_size must be in [1, cohort size {k}]; "
                         f"got {K} (the plan stream supplies k uploads per "
                         f"wave for rounds waves)")
    Mc = int(fed.async_concurrency) if fed.async_concurrency else k
    if Mc < 1:
        raise ValueError(f"async_concurrency must be >= 1; got {Mc}")
    decay = float(fed.staleness_decay)
    if not 0.0 < decay <= 1.0:
        raise ValueError(f"staleness_decay must be in (0, 1]; got {decay}")
    latency = sampling.LatencyModel(fed.latency, fed.latency_scale,
                                    fed.latency_sigma)
    fingerprint = async_fingerprint(fed, K, Mc)
    chunk = max(1, int(fed.chunk_rounds))
    eval_every = max(1, int(fed.eval_every))

    # faults, admission and retries; ``track`` widens the history and the
    # checkpoint whenever retries or rejections can happen, so the
    # fault-free config keeps the plain ledger and layout
    fm = faults.fault_model_of(fed)
    adm = admission.control_of(fed)
    robust = fm.active or adm.enabled
    timeout = float(fed.dispatch_timeout)
    track = robust or timeout > 0

    pstore = client_store.make_store("device", states, parallelism=mode,
                                     device=dev)
    put = pstore.place
    state_ref = {"stacked": pstore.resident()}

    codec = compress.get_codec(fed.uplink_codec)
    compressed = not codec.is_identity and strategy.aggregate != "none"
    payload_struct = strategy.uplink(meta_like(state_ref["stacked"]))
    has_payload = payload_struct is not None
    per_b, per_e, per_down_b = compress.per_client_traffic(
        codec, payload_struct, m, compressed)

    personalized = strategy.aggregate == "personalized"
    use_data = personalized and fed.use_data_sim and s_data is not None
    use_model = personalized and fed.use_model_sim
    if personalized and not (use_data or use_model):
        raise ValueError(
            f"celora needs at least one similarity term; got "
            f"use_data_sim={fed.use_data_sim}, "
            f"use_model_sim={fed.use_model_sim}")
    sm_ref = {"s_model": cka.pairwise_model_similarity_stacked(
        tri_lora.tree_payload(state_ref["stacked"]["adapter"]), cka_probes)
        if use_model else None}
    counts = torch.as_tensor(np.asarray(sample_counts, np.float32),
                             device=dev)
    eta = fed.pfedme_eta
    seed = fed.seed

    def fit(st, ids, recs, toks, labs, divm=None):
        """The fit group: gather the dispatched rows, the stacked local fit
        and ``after_local``, the uplink encoded with each record's
        (wave, client) uniforms (EF advanced), scattered back."""
        rows = client_batch.gather_clients(st, ids)
        ef_prev = rows["ef"] if compressed else None
        tr, losses = local_fit(strategy.trainable(rows), rows.get("w", {}),
                               toks, labs)
        new = strategy.after_local(dict(rows, **tr), eta)
        if divm is not None:
            # divergent fit: the resident state reverts to the round start
            # while the upload blows up by divergent_scale
            new = client_batch.select_clients(~divm, new, rows)
        if compressed:
            payload = strategy.uplink(new)
            if divm is not None:
                payload = faults.scale_rows(payload, divm,
                                            fm.divergent_scale)
            # the sync engines' per-(round, client) stream: the record's
            # wave IS its sync round
            _, served, ef_new = compress.encode_stacked(
                codec, payload, new["ef"],
                [sr_uniforms(r.wave, r.client) for r in recs])
            new = dict(new, ef=ef_new)
        else:
            served = strategy.uplink(new)        # None for aggregate="none"
            if served is not None and divm is not None:
                served = faults.scale_rows(served, divm, fm.divergent_scale)
        return (client_batch.scatter_clients(st, ids, new), losses, served,
                ef_prev)

    def flush(st, s_model_c, served_k, ids, stale, accept_k=None,
              ef_k=None):
        """Scatter the buffered uploads over the current payload, refresh
        the contributors' S^model rows, discount by staleness, aggregate,
        install into the accepted contributors."""
        pmask = client_batch.id_mask(m, ids)
        amask = (client_batch.id_mask(m, ids, accept_k)
                 if accept_k is not None else pmask)
        col = None
        if decay != 1.0:
            # decay == 1.0 keeps the sync aggregation (col_scale=None)
            col = torch.ones(m, dtype=torch.float32, device=dev).index_copy(
                0, ids, torch.pow(decay, stale.to(torch.float32)))
        if accept_k is not None and ef_k is not None:
            # EF rollback: a rejected upload never advances the residual
            cur = client_batch.gather_clients(st["ef"], ids)
            st = dict(st, ef=client_batch.scatter_clients(
                st["ef"], ids, client_batch.select_clients(
                    accept_k, cur, ef_k)))
        served_m = client_batch.scatter_clients(strategy.uplink(st), ids,
                                                served_k)
        weights = None
        if use_model:
            cs = cka.stacked_cs(served_m if compressed
                                else tri_lora.tree_payload(st["adapter"]))
            if accept_k is not None:
                # only ACCEPTED rows refresh; pairs touching a buffered but
                # rejected client keep their previous entry
                refreshed = cka.refresh_rows_inline(s_model_c, cs, ids,
                                                    cka_probes)
                clean = ~pmask | amask
                valid = ((amask[:, None] & clean[None, :])
                         | (amask[None, :] & clean[:, None]))
                s_model_c = torch.where(valid, refreshed, s_model_c)
            else:
                # the eager round's refresh: the whole matrix when every
                # client contributed, so that the zero-staleness flush
                # computes the sync round's weights bit for bit
                s_model_c = cka.refresh_pairwise_cka(s_model_c, cs, ids,
                                                     cka_probes)
        if personalized:
            sims = ([s_data] if use_data else []) \
                + ([s_model_c] if use_model else [])
            weights = aggregation.personalized_weights(
                sum(sims), fed.self_weight, amask, col_scale=col)
        if accept_k is not None:
            # rejected rows may hold NaN/Inf; their weight is 0 but 0 x NaN
            # still poisons the aggregation
            served_m = faults.zero_rows(served_m, amask | ~pmask)
        down = strategy.server_stacked(served_m, sample_counts=counts,
                                       weights=weights, participants=amask,
                                       col_scale=col)
        if down is not None:
            st = client_batch.select_clients(
                amask, strategy.install(st, down), st)
        return st, s_model_c

    # ---- host driver state
    waves = [np.asarray(p.sampled) for p in plans]
    consumed = np.zeros(m, np.int64)     # per-client completed draw sessions
    hist = {"loss": [], "accs": [], "wall": [], "sim": [], "stale": [],
            "ids": [], "tx": [], "nacc": [], "rej": [], "fail": []}
    accs_carry = [np.zeros(m, np.float32)]
    t_last = [time.perf_counter()]
    sched_ref: dict = {}
    adm_ref = {"state": admission.init_state(adm.window, dev)
               if adm.enabled else None}
    drop_pending: list = []     # clients dropped for good since last flush
    fit_groups: list = []

    fail_of = None
    if fm.active:
        def fail_of(w, c, a):
            crash, loss, _, _ = fm.draw_one(w, c, seed, a)
            return crash, loss

    def on_drop(rec):
        # a record abandoned for good: count it in the next flush's row and
        # roll its EF residual back (the payload never lands)
        drop_pending.append(int(rec.client))
        if compressed and rec.ef_prev is not None:
            st = state_ref["stacked"]
            ids1 = torch.tensor([rec.client], device=dev)
            ef1 = tree_map(lambda l: l[None], rec.ef_prev)
            state_ref["stacked"] = dict(st, ef=client_batch.scatter_clients(
                st["ef"], ids1, ef1))

    def fit_group(records):
        toks, labs = [], []
        for r in records:
            ld = loaders[r.client]
            # fast-forward the client's stream over the waves it was not
            # dispatched for: session index == wave, exactly the sync
            # engines' one session per round
            while consumed[r.client] < r.wave:
                ld.skip(fed.local_steps)
                consumed[r.client] += 1
            bt = list(ld.batches(fed.local_steps))
            consumed[r.client] += 1
            toks.append(np.stack([b["tokens"] for b in bt]))
            labs.append(np.stack([b["labels"] for b in bt]))
        fit_groups.append(len(records))
        ids = torch.tensor([r.client for r in records], device=dev)
        tk, lb = client_batch.to_device(
            (client_batch.host_tensor(np.stack(toks), dev),
             client_batch.host_tensor(np.stack(labs), dev)), dev)
        divm = None
        if fm.active:
            divm = torch.tensor([fm.draw_one(r.wave, r.client, seed,
                                             r.attempt)[3] for r in records],
                                device=dev)
        new_st, losses, served, ef_prev = fit(
            state_ref["stacked"], ids, records, put(tk), put(lb), divm)
        state_ref["stacked"] = new_st
        losses = losses.cpu().numpy()
        for j, r in enumerate(records):
            r.loss = float(losses[j])
            if served is not None:
                r.upload = tree_map(lambda l, j=j: l[j], served)
            if ef_prev is not None:
                r.ef_prev = tree_map(lambda l, j=j: l[j], ef_prev)

    def stack(rows):
        return tree_map(lambda *xs: torch.stack(xs), *rows)

    def on_flush(records, f, sim_now):
        ids_np = np.asarray([r.client for r in records], np.int64)
        ids = torch.as_tensor(ids_np, device=dev)
        stale = np.asarray([f - r.version for r in records], np.float64)
        stale_t = torch.as_tensor(stale, device=dev)
        accept_np = np.ones(len(records), bool)
        if has_payload and not track:
            st, sm = flush(state_ref["stacked"], sm_ref["s_model"],
                           stack([r.upload for r in records]), ids, stale_t)
            state_ref["stacked"], sm_ref["s_model"] = st, sm
        elif has_payload:
            ups = [r.upload for r in records]
            if fm.active and fm.corrupt > 0:
                # per-record corruption in transit (the uploads are already
                # decoded, so a bit flip mangles the decoded rows)
                for j, r in enumerate(records):
                    if fm.draw_one(r.wave, r.client, seed, r.attempt)[2]:
                        ups[j] = faults.corrupt_one(None, None, ups[j],
                                                    fm.corrupt_mode)
            served_k = stack(ups)
            if adm.enabled:
                norms, finite = admission.payload_stats(served_k)
                acc, adm_ref["state"] = admission.admit(
                    norms, finite,
                    torch.ones(len(records), dtype=torch.bool, device=dev),
                    adm_ref["state"], adm)
                accept_np = acc.cpu().numpy()
            ef_k = stack([r.ef_prev for r in records]) if compressed \
                else None
            st, sm = flush(state_ref["stacked"], sm_ref["s_model"], served_k,
                           ids, stale_t,
                           torch.as_tensor(accept_np, device=dev), ef_k)
            state_ref["stacked"], sm_ref["s_model"] = st, sm
        evaluated = f % eval_every == 0 or f == fed.rounds - 1
        if evaluated:
            accs_carry[0] = eval_acc(strategy.trainable(state_ref["stacked"]),
                                     test_toks, test_labs).cpu().numpy()
        now = time.perf_counter()
        hist["loss"].append(float(np.mean([r.loss for r in records])))
        hist["accs"].append([float(a) for a in accs_carry[0]])
        hist["wall"].append(now - t_last[0])
        t_last[0] = now
        hist["sim"].append(float(sim_now))
        hist["stale"].append(float(np.mean(stale)))
        hist["ids"].append(sorted(int(i) for i in ids_np))
        if track:
            sched = sched_ref["sched"]
            tx_total = sum(r.tx for r in records) + sched.orphan_tx
            sched.orphan_tx = 0
            hist["tx"].append(int(tx_total))
            hist["nacc"].append(int(accept_np.sum()))
            hist["rej"].append(sorted(int(i) for i in ids_np[~accept_np]))
            hist["fail"].append(sorted(drop_pending))
            drop_pending.clear()
        if fed.checkpoint_path and ((f + 1) % chunk == 0
                                    or f + 1 == fed.rounds):
            _save_async(fed, sched_ref["sched"], state_ref["stacked"],
                        sm_ref["s_model"], hist, consumed, fingerprint,
                        has_payload, strategy, adm_state=adm_ref["state"],
                        track=track, track_ef=compressed and track)
        if verbose:
            print(f"[{strategy.name}] flush {f:3d} t={sim_now:8.2f} "
                  f"loss {hist['loss'][-1]:.4f} "
                  f"acc {float(np.mean(hist['accs'][-1])):.3f} "
                  f"stale {hist['stale'][-1]:.2f} "
                  f"({len(ids_np)} uploads)")

    sched = AsyncScheduler(waves=waves, m=m, latency=latency, seed=seed,
                           buffer_size=K, concurrency=Mc, rounds=fed.rounds,
                           fit_group=fit_group, flush_cb=on_flush,
                           timeout=timeout, backoff=float(fed.retry_backoff),
                           retry_cap=int(fed.retry_cap), fail_of=fail_of,
                           on_drop=on_drop)
    sched_ref["sched"] = sched

    # ---- resume from a flush-boundary checkpoint
    if fed.checkpoint_path and fed.resume and \
            not os.path.exists(fed.checkpoint_path):
        warnings.warn(f"resume: no checkpoint at {fed.checkpoint_path!r} — "
                      f"starting from flush 0 (checkpoints will be written "
                      f"there)")
    if fed.checkpoint_path and fed.resume and \
            os.path.exists(fed.checkpoint_path):
        st0, sm0, tree, pending, served_p, deferred, meta = _load_async(
            fed, state_ref["stacked"], sm_ref["s_model"], m, fingerprint,
            payload_struct, has_payload, dev)
        state_ref["stacked"] = put(st0)
        sm_ref["s_model"] = sm0
        done = int(meta["rounds_done"])
        hist["loss"] = [float(v) for v in tree["loss"]]
        hist["accs"] = [list(map(float, row)) for row in tree["accs"]]
        hist["wall"] = [float(v) for v in tree["wall"]]
        hist["sim"] = [float(v) for v in tree["sim"]]
        hist["stale"] = [float(v) for v in tree["stale"]]
        hist["ids"] = [[int(i) for i in row] for row in tree["pids"]]
        if track and "robust" in tree:
            rb = tree["robust"]
            hist["tx"] = [int(v) for v in rb["tx"]]
            hist["nacc"] = [int(v) for v in rb["nacc"]]

            def unflatten(counts_, vals):
                out, at = [], 0
                for n in (int(c) for c in counts_):
                    out.append([int(i) for i in vals[at:at + n]])
                    at += n
                return out

            hist["rej"] = unflatten(rb["rejc"], rb["rejv"])
            hist["fail"] = unflatten(rb["failc"], rb["failv"])
        if adm.enabled and "admission" in tree:
            adm_ref["state"] = tree["admission"]
        consumed[:] = np.asarray(tree["consumed"])
        accs_carry[0] = np.asarray(hist["accs"][-1], np.float32)
        # fast-forward every client's data stream to its stored position
        for i in range(m):
            for _ in range(int(consumed[i])):
                loaders[i].skip(fed.local_steps)
        sched.version = done
        sched.sim_now = float(meta["sim_now"])
        sched.next_seq = int(meta["next_seq"])
        sched.wc = int(meta["wc"])
        sched.wi = int(meta["wi"])
        sched.orphan_tx = int(meta.get("orphan_tx", 0))
        sched.n_dropped = int(meta.get("n_dropped", 0))
        if "attempts" in tree:
            at = tree["attempts"]
            for w, c, n in zip(np.atleast_1d(at["wave"]),
                               np.atleast_1d(at["client"]),
                               np.atleast_1d(at["n"])):
                sched._attempts[(int(w), int(c))] = int(n)
        for w, c in zip(np.atleast_1d(deferred.get("wave", [])),
                        np.atleast_1d(deferred.get("client", []))):
            sched.deferred.append((int(w), int(c)))
            sched._deferred_clients[int(c)] = \
                sched._deferred_clients.get(int(c), 0) + 1
        if pending:
            ef_p = tree.get("pending_ef")
            for j in np.argsort(np.asarray(pending["seq"])):
                rec = Arrival(seq=int(pending["seq"][j]),
                              client=int(pending["client"][j]),
                              wave=int(pending["wave"][j]),
                              version=int(pending["version"][j]),
                              arrival=float(pending["arrival"][j]),
                              loss=float(pending["loss"][j]))
                if "attempt" in pending:
                    rec.attempt = int(pending["attempt"][j])
                    rec.failed = _FNAME[int(pending["fcode"][j])]
                    rec.tx = int(pending["tx"][j])
                if served_p is not None and rec.failed != "crash":
                    rec.upload = tree_map(lambda l, j=j: l[j], served_p)
                if ef_p is not None and rec.failed != "crash":
                    rec.ef_prev = tree_map(lambda l, j=j: l[j], ef_p)
                sched.by_seq[rec.seq] = rec
                sched.busy.add(rec.client)
                sched.in_flight += 1
                heapq.heappush(sched.heap, (rec.arrival, rec.seq))
        if verbose:
            print(f"[{strategy.name}] resumed {done} flushes "
                  f"from {fed.checkpoint_path}")

    t_last[0] = time.perf_counter()
    sched.run()

    def n_up(f: int) -> int:
        # with retries every transmission is priced, orphans included
        return hist["tx"][f] if track else K

    def n_down(f: int) -> int:
        return hist["nacc"][f] if track else K

    history = [
        RoundRecord(
            f, hist["loss"][f], hist["accs"][f],
            uplink_bytes=per_b * n_up(f),
            downlink_bytes=per_down_b * n_down(f),
            wall_s=hist["wall"][f],
            participants=hist["ids"][f], sampled=hist["ids"][f], dropped=[],
            uplink_elems=per_e * n_up(f),
            evaluated=(f % eval_every == 0 or f == fed.rounds - 1),
            rejected=hist["rej"][f] if track else [],
            failed=hist["fail"][f] if track else [])
        for f in range(fed.rounds)]

    return {
        "method": strategy.name,
        "history": history,
        "final_accs": history[-1].accs,
        "mean_acc": history[-1].mean_acc,
        "min_acc": history[-1].min_acc,
        "max_acc": history[-1].max_acc,
        "uplink_floats_per_round": history[-1].uplink_elems,
        "uplink_bytes_per_round": history[-1].uplink_bytes,
        "downlink_bytes_per_round": history[-1].downlink_bytes,
        "sim_times": list(hist["sim"]),
        "staleness_mean": list(hist["stale"]),
        "fit_groups": fit_groups,
        "states": client_batch.unstack_states(state_ref["stacked"]),
    }
