"""Population residency of the vectorized runtime: PyTorch port of
``repro.core.client_store``.

``FedConfig.client_store`` picks where the m clients' states live:

* ``"device"`` — the whole population as one stacked state (leaves
  (m, …)) on the device, which the eager vectorized round and the scan
  engine update wholesale.
* ``"host"`` — the population as stacked CPU tensors (pinned when the run
  is on a card); each round brings only the ACTIVE COHORT (the sampled
  clients, stragglers included, since they train) to the device, fits it,
  and writes its rows back (:func:`run_cohort`).  Device residency is O(k)
  client rows plus, for personalized aggregation, an O(m) bank of the
  small r×r C payloads (the CKA refresh compares a refreshed row against
  all m columns, and a compressed run re-encodes every client's C under
  the round's uniform stream) — never the O(m) adapter and optimizer
  state.
* ``"sharded"`` — the stacked client axis laid over the 1-D
  ``("clients",)`` device mesh (:func:`repro_torch.launch.mesh.
  make_client_mesh`): d row blocks, one per mesh device; cohort gather and
  scatter run per block (a masked local take and an exact combine, a
  drop-scatter), and the rounds compute on the run's device (at d = 1, one
  card, the device store exactly).

Store contract (the JAX package's): ``gather(ids)`` returns the cohort rows
on the device and ``scatter(ids, rows)`` writes them back, so that
``scatter(ids, gather(ids))`` is the identity for any id set; a gather sees
the population as of the last completed round.  On a card the host store's
write-back is a ``non_blocking`` copy into pinned memory, so every read of
the host rows (the next gather, :meth:`HostClientStore.unstack`, a
checkpoint) first waits for the copies it posted (an event per scatter).

:func:`run_cohort` is the host store's round loop on both engines (the
eager one, and the scan engine's checkpoint cadence and ``resume``): the
cohort's batches are drawn for the sampled clients only, on a
:class:`.client_batch.ChunkPrefetcher` thread under the scan engine, while
every other client's loader skips its draws, so the data streams stay
those of the all-m engines.  The round itself is the scan engine's round
restricted to k rows — the k-row fit, the all-m C bank and EF bank, the
k×k restriction of the eqn-(3) weights (exact: participants ⊆ cohort) —
as a plain function of tensors, as the port's eager vmap round is.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (admission, aggregation, client_batch,
                              compress, faults, sampling)
from repro_torch.core.similarity import cka
from repro_torch.launch import mesh as mesh_lib
from repro_torch.tree import tree_leaves, tree_map

STORE_BACKENDS = ("device", "sharded", "host")


def make_store(backend: str, states: Sequence[Any], *,
               parallelism: str = "vmap", device=None, devices=None):
    """The population store for ``backend`` from m per-client states
    (``device``: the run's device, default the states'; ``devices``: the
    devices the client axis is laid over, default
    :func:`repro_torch.launch.mesh.run_devices` of the run's device).  The
    device store honours ``parallelism="shard"``'s placement, as the JAX
    package's does."""
    if backend not in STORE_BACKENDS:
        raise ValueError(f"client_store={backend!r}; "
                         f"expected one of {STORE_BACKENDS}")
    if backend == "sharded":
        return ShardedClientStore(states, device=device, devices=devices)
    if backend == "host":
        return HostClientStore(states, device=device)
    return DeviceClientStore(states, shard=(parallelism == "shard"),
                             device=device, devices=devices)


class DeviceClientStore:
    """The whole population as one stacked state on the run's device.
    ``gather`` / ``scatter`` are plain row indexing, so that every store
    keeps one contract.

    ``shard=True`` (``client_parallelism="shard"``) lays the population
    over the 1-D ``("clients",)`` mesh of
    :func:`repro_torch.launch.mesh.make_client_mesh`: d row blocks of m/d
    rows, block i on mesh device i.  The round programs still compute on
    the run's device: :meth:`resident` is the block itself at d = 1 (one
    card: the vmap path exactly) and the blocks joined in order at d > 1,
    and :meth:`adopt` splits an updated population back into its blocks."""

    backend = "device"

    def __init__(self, states: Sequence[Any], *, shard: bool = False,
                 device=None, devices=None):
        self.m = len(states)
        self.device = torch.device(device if device is not None else
                                   tree_leaves(states[0])[0].device)
        stacked = client_batch.stack_states(states)
        self.mesh = None
        if shard:
            self.mesh = mesh_lib.make_client_mesh(
                self.m, mesh_lib.run_devices(self.device)
                if devices is None else devices)
        self.adopt(stacked)

    @property
    def per_block(self) -> int:
        return self.m // (1 if self.mesh is None else self.mesh.size)

    def resident(self) -> Any:
        """The stacked population the round updates on the run's device;
        hand an updated one back through :meth:`adopt`."""
        if self.mesh is None:
            return self._stacked
        return mesh_lib.join_clients(self._blocks, self.device)

    def adopt(self, stacked: Any) -> None:
        """Install an updated stacked population as current."""
        if self.mesh is None:
            self._stacked = stacked
        else:
            self._blocks = mesh_lib.shard_clients(self.mesh, stacked)

    def place(self, tree: Any) -> Any:
        """Lay a client-axis tree out for the round: the identity, since
        the rounds compute on the run's device."""
        return tree

    def gather(self, ids) -> Any:
        return client_batch.gather_clients(self.resident(), ids)

    def scatter(self, ids, values: Any) -> None:
        self.adopt(client_batch.scatter_clients(self.resident(), ids,
                                                values))

    def unstack(self) -> list:
        return client_batch.unstack_states(self.resident())


class ShardedClientStore(DeviceClientStore):
    """The client axis over the ``("clients",)`` mesh (``client_store=
    "sharded"``): d row blocks of m/d rows, block i on mesh device i, and
    the cohort moves per block, as the JAX package's ``shard_map``
    programs move it:

    * gather — each block takes its LOCAL rows of the id vector through a
      masked block index and zeros the rows it does not own; the blocks'
      rows are moved to the run's device and combined in block order.
      Each row has exactly one owner, so the combine (the JAX package's
      ``psum``) is exact; it is done as a select of the owner's row, which
      keeps every bit (a -0.0 too, which a sum with 0.0 would not).
    * scatter — each block maps the ids it owns to block-local positions
      and writes only those rows (the JAX package's drop-scatter).

    Ids must be unique (participation plans are sorted unique)."""

    backend = "sharded"

    def __init__(self, states: Sequence[Any], *, device=None, devices=None):
        super().__init__(states, shard=True, device=device, devices=devices)

    def _owned(self, ids) -> list:
        """Per block: (its first row, the id vector, the (k,) mask of the
        ids the block owns), on the host."""
        idx = torch.as_tensor(np.asarray(ids, np.int64).reshape(-1))
        per = self.per_block
        return [(i * per, idx, (idx >= i * per) & (idx < (i + 1) * per))
                for i in range(len(self._blocks))]

    def gather(self, ids) -> Any:
        owned = self._owned(ids)

        def one(*blocks):
            out = None
            for t, (lo, idx, local) in zip(blocks, owned):
                rows = t[torch.where(local, idx - lo, 0).to(t.device)]
                mask = local.to(t.device).reshape(
                    (-1,) + (1,) * (rows.dim() - 1))
                rows = torch.where(mask, rows, torch.zeros_like(rows))
                rows, mask = rows.to(self.device), mask.to(self.device)
                out = rows if out is None else torch.where(mask, rows, out)
            return out
        return tree_map(one, *self._blocks)

    def scatter(self, ids, values: Any) -> None:
        blocks = []
        for block, (lo, idx, local) in zip(self._blocks, self._owned(ids)):
            sel = torch.nonzero(local).reshape(-1)
            pos = idx[sel] - lo

            def put(t, v, sel=sel, pos=pos):
                if not len(sel):
                    return t
                rows = v[sel.to(v.device)].to(t.device, t.dtype)
                return t.index_copy(0, pos.to(t.device), rows)
            blocks.append(tree_map(put, block, values))
        self._blocks = blocks


class HostClientStore:
    """The population as stacked CPU tensors (leaves (m, …)), pinned when
    ``device`` is a card.  ``gather`` takes the rows on the host and moves
    them by one ``non_blocking`` copy per leaf; ``scatter`` posts the
    device rows' copies back into pinned staging and records an event,
    and the rows land in the population at the next read of it."""

    backend = "host"

    def __init__(self, states: Sequence[Any], *, device=None):
        self.m = len(states)
        self.device = torch.device(device if device is not None else
                                   tree_leaves(states[0])[0].device)
        self._pinned = self.device.type == "cuda"
        self._pending: list = []        # (ids, staged rows, event)
        self._population = self._host(client_batch.stack_states(
            [tree_map(lambda t: t.detach().cpu(), s) for s in states]))

    def _host(self, tree: Any) -> Any:
        def one(t):
            t = t.detach().cpu().contiguous()
            return t.pin_memory() if self._pinned and not t.is_pinned() \
                else t
        return tree_map(one, tree)

    def _settle(self) -> None:
        """Land every posted write-back: wait for its copies, then write
        the staged rows into the population."""
        pending, self._pending = self._pending, []
        for idx, rows, event in pending:
            if event is not None:
                event.synchronize()
            tree_map(lambda l, v: l.index_copy_(0, idx, v.to(l.dtype)),
                     self._population, rows)

    @property
    def population(self) -> Any:
        """The stacked host population, every posted write-back landed."""
        self._settle()
        return self._population

    def load(self, population: Any) -> None:
        """Replace the population wholesale (a checkpoint restore)."""
        self._pending = []
        self._population = self._host(population)

    def gather(self, ids) -> Any:
        idx = torch.as_tensor(np.asarray(ids, np.int64))
        pop = self.population

        def take(l):
            rows = l.index_select(0, idx)
            if not self._pinned:
                return rows.to(self.device)
            return rows.pin_memory().to(self.device, non_blocking=True)
        return tree_map(take, pop)

    def scatter(self, ids, values: Any) -> None:
        idx = torch.as_tensor(np.asarray(ids, np.int64))
        if not self._pinned:
            tree_map(lambda l, v: l.index_copy_(
                0, idx, v.detach().to("cpu", l.dtype)),
                self._population, values)
            return

        def stage(v):
            out = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            return out.copy_(v.detach(), non_blocking=True)
        rows = tree_map(stage, values)
        event = torch.cuda.Event()
        event.record()
        self._pending.append((idx, rows, event))

    def unstack(self) -> list:
        pop = self.population
        return [tree_map(lambda l, i=i: l[i], pop) for i in range(self.m)]


# ---------------------------------------------------------------------------
# the host store's round loop
# ---------------------------------------------------------------------------

def _cohort_step(*, strategy, fed, local_fit: Callable, use_data: bool,
                 use_model: bool, codec, sr_uniforms, cka_probes,
                 s_data, counts: torch.Tensor) -> Callable:
    """The round of the host store on its k-row cohort (the JAX package's
    ``_build_cohort_fn``): fit, the all-m C / EF banks, the masked S^model
    refresh, the k×k aggregation and the install.  The restriction is
    exact, not approximate: participants ⊆ sampled = cohort, so every
    nonzero column of the personalized weights (and every nonzero FedAvg
    weight) indexes a cohort row."""
    m = fed.n_clients
    eta = fed.pfedme_eta
    communicates = strategy.aggregate != "none"
    compressed = not codec.is_identity and communicates
    personalized = strategy.aggregate == "personalized"
    fm = faults.fault_model_of(fed)
    adm = admission.control_of(fed)
    robust = fm.active or adm.enabled

    def step(cohort, bank, ef_bank, s_model, adm_state, x: dict, rnd: int):
        """``x``: the round's device tensors — toks, labs, the (k,) cohort
        mask ``pml``, the (m,) participant mask ``pmf``, the sorted cohort
        ids ``cids`` (and their host copy ``cids_np``), and with faults the
        (k,) cohort rows of the crash / loss / corrupt / divergent draws."""
        pml, pmf, cids, cids_np = x["pml"], x["pmf"], x["cids"], x["cids_np"]
        prev_c = dict(cohort)
        tr, losses = local_fit(strategy.trainable(cohort),
                               cohort.get("w", {}), x["toks"], x["labs"])
        cohort = strategy.after_local(dict(cohort, **tr), eta)
        if fm.active:
            # crash: the round's local work is lost; divergent: the
            # client's divergence detection resets to the round start
            cohort = client_batch.select_clients(
                ~(x["crash"] | x["divergent"]), cohort, prev_c)
        payload = strategy.uplink(cohort)
        if fm.active and fm.divergent > 0:
            # the divergent upload is the blowup the norm gate must catch
            payload = faults.scale_rows(payload, x["divergent"],
                                        fm.divergent_scale)
        if fm.active:
            delivered_l = pml & ~x["crash"] & ~x["loss"]
        else:
            delivered_l = pml
        if use_model:
            # fresh cohort Cs join the all-m bank BEFORE the encode and the
            # refresh: the CKA columns see the sampled clients' new Cs and
            # everyone else's frozen ones
            bank = client_batch.scatter_clients(bank, cids, payload)
        enc_c = ef_all = ef_new = None
        if compressed:
            if use_model:
                # the device engines encode ALL m every round, and the
                # unsampled clients' decoded Cs vary with the round's
                # uniforms: the full-bank encode keeps that stream
                enc_all, dec_all, ef_all = compress.encode_stacked(
                    codec, bank, ef_bank,
                    [sr_uniforms(rnd, i) for i in range(m)])
                if not robust:
                    ef_bank = client_batch.select_clients(pmf, ef_all,
                                                          ef_bank)
                    cohort = dict(cohort, ef=client_batch.gather_clients(
                        ef_bank, cids))
                if fm.active and fm.corrupt > 0:
                    enc_c = client_batch.gather_clients(enc_all, cids)
                served_all = dec_all
                served = client_batch.gather_clients(dec_all, cids)
            else:
                # no CKA: only cohort payloads are consumed, and a client's
                # uniforms depend on (round, client) alone, so the cohort
                # encode equals the all-m one row for row
                enc_c, served, ef_new = compress.encode_stacked(
                    codec, payload, cohort["ef"],
                    [sr_uniforms(rnd, int(i)) for i in cids_np])
                if not robust:
                    cohort = dict(cohort, ef=client_batch.select_clients(
                        pml, ef_new, cohort["ef"]))
                served_all = None
        else:
            served = payload
            served_all = bank
        if fm.active and fm.corrupt > 0 and communicates:
            served = faults.corrupt_served(codec if compressed else None,
                                           enc_c, served,
                                           delivered_l & x["corrupt"],
                                           fm.corrupt_mode)
            if served_all is not None:
                # the server's m-wide CKA view sees the mangled rows too
                served_all = client_batch.scatter_clients(served_all, cids,
                                                          served)
        accept_l = delivered_l
        if robust and communicates:
            if adm.enabled:
                # participants ⊆ cohort: the k-row gate computes the same
                # masked medians as the device engines' m-row one
                norms, finite = admission.payload_stats(served)
                accept_l, adm_state = admission.admit(
                    norms, finite, delivered_l, adm_state, adm)
            if compressed:
                # EF advances only for ACCEPTED uploads
                if use_model:
                    ef_bank = client_batch.select_clients(
                        client_batch.id_mask(m, cids, accept_l), ef_all,
                        ef_bank)
                    cohort = dict(cohort, ef=client_batch.gather_clients(
                        ef_bank, cids))
                else:
                    cohort = dict(cohort, ef=client_batch.select_clients(
                        accept_l, ef_new, cohort["ef"]))
        agg_l = accept_l if robust and communicates else pml
        agg_f = (client_batch.id_mask(m, cids, accept_l)
                 if robust and communicates else pmf)
        weights = None
        if personalized:
            sims = [s_data] if use_data else []
            if use_model:
                refreshed = cka.refresh_rows_inline(
                    s_model, cka.stacked_cs(served_all), cids, cka_probes)
                if robust:
                    # refresh only ACCEPTED rows; a pair touching a sampled
                    # but unaccepted client keeps its previous entry
                    clean = ~client_batch.id_mask(m, cids) | agg_f
                    valid = ((agg_f[:, None] & clean[None, :])
                             | (agg_f[None, :] & clean[:, None]))
                    s_model = torch.where(valid, refreshed, s_model)
                else:
                    s_model = refreshed
                sims.append(s_model)
            w_full = aggregation.personalized_weights(
                sum(sims), fed.self_weight, agg_f)
            weights = w_full[cids[:, None], cids[None, :]]
        if robust and communicates:
            # rejected or undelivered rows may hold NaN/Inf: their weight
            # is 0, but 0 x NaN still poisons the mix
            served = faults.zero_rows(served, accept_l)
        down = strategy.server_stacked(served, sample_counts=counts[cids],
                                       weights=weights, participants=agg_l)
        if down is not None:
            cohort = client_batch.select_clients(
                agg_l, strategy.install(cohort, down), cohort)
        if use_model:
            # re-scatter AFTER the install: a bank row is "the client's
            # current C"
            bank = client_batch.scatter_clients(bank, cids,
                                                strategy.uplink(cohort))
        return (cohort, bank, ef_bank, s_model, adm_state, losses.mean(),
                accept_l)

    return step


def run_cohort(*, task, fed, strategy, states: list, loaders: Sequence,
               sample_counts: Sequence[int],
               plans: Sequence[sampling.ParticipationPlan],
               local_fit: Callable, eval_acc: Callable,
               s_data: Optional[torch.Tensor],
               test_toks: np.ndarray, test_labs: np.ndarray,
               cka_probes: Optional[torch.Tensor],
               sr_uniforms: Optional[Callable], device,
               verbose: bool = False) -> dict:
    """The ``client_store="host"`` body of ``run_federated`` (both
    engines): host-resident population, device-resident cohorts.
    ``local_fit`` and ``eval_acc`` are the stacked fit and eval of the
    vectorized path; ``test_toks`` / ``test_labs`` are HOST arrays (m, pad,
    T) / (m, pad), evaluated in device slabs of at most 64 clients.
    Returns ``run_federated``'s result dict, whose ``device_resident_bytes``
    counts what stays on the device between rounds (the C bank, its EF
    residual and S^model)."""
    from repro_torch.core import fed_engine
    from repro_torch.core.federated import (RoundRecord, _do_eval,
                                            _print_round)

    dev = torch.device(device)
    m = fed.n_clients
    k = len(plans[0].sampled)
    if any(len(p.sampled) != k for p in plans):
        raise ValueError("run_cohort needs a round-invariant sampled count")
    chunk = max(1, int(fed.chunk_rounds))
    scan_engine = fed.engine == "scan"
    store = HostClientStore(states, device=dev)
    del states

    codec = compress.get_codec(fed.uplink_codec)
    communicates = strategy.aggregate != "none"
    compressed = not codec.is_identity and communicates
    personalized = strategy.aggregate == "personalized"
    use_data = personalized and fed.use_data_sim and s_data is not None
    use_model = personalized and fed.use_model_sim
    if personalized and not (use_data or use_model):
        raise ValueError(
            f"celora needs at least one similarity term; got "
            f"use_data_sim={fed.use_data_sim}, "
            f"use_model_sim={fed.use_model_sim}")

    fm = faults.fault_model_of(fed)
    adm = admission.control_of(fed)
    robust = fm.active or adm.enabled
    adm_state = admission.init_state(adm.window, dev) if adm.enabled else None
    fdraws = ([fm.draw(m, rnd, fed.seed) for rnd in range(fed.rounds)]
              if fm.active else None)

    # per-client byte constants from shapes alone, as the device engines
    per_b, per_e, per_down_b = compress.per_client_traffic(
        codec, strategy.uplink(fed_engine.meta_like(store.population)), m,
        compressed)

    def build_banks():
        """The all-m device bank of the clients' current Cs (and their EF
        residual when compressed), from the host population."""
        if not use_model:
            return None, None

        def copy(tree):     # a copy: never an alias of the host rows
            return tree_map(lambda t: t.to(dev, non_blocking=True,
                                           copy=True), tree)
        pop = store.population
        return (copy(strategy.uplink(pop)),
                copy(pop["ef"]) if compressed else None)

    bank, ef_bank = build_banks()
    s_model = (cka.pairwise_model_similarity_stacked(bank, cka_probes)
               if use_model else None)
    counts = torch.as_tensor(np.asarray(sample_counts, np.float32),
                             device=dev)
    step = _cohort_step(strategy=strategy, fed=fed, local_fit=local_fit,
                        use_data=use_data, use_model=use_model, codec=codec,
                        sr_uniforms=sr_uniforms, cka_probes=cka_probes,
                        s_data=s_data if use_data else None, counts=counts)

    def eval_population() -> list:
        # slabbed eval: the device holds O(slab) clients, never O(m)
        slab = max(k, min(m, 64))
        out = np.zeros(m, np.float32)
        for lo in range(0, m, slab):
            ids = np.arange(lo, min(lo + slab, m))
            st = store.gather(ids)
            tk, lb = client_batch.to_device(
                (client_batch.host_tensor(test_toks[ids], dev),
                 client_batch.host_tensor(test_labs[ids], dev)), dev)
            out[ids] = eval_acc(strategy.trainable(st), tk, lb).cpu().numpy()
        return [float(v) for v in out]

    # ---- resume from a chunk-boundary checkpoint (scan engine contract)
    hist_loss: list = []
    hist_accs: list = []
    hist_wall: list = []
    hist_acc_rows: list = []       # per-round (m,) accepted-upload masks
    start = 0
    if scan_engine and fed.checkpoint_path and fed.resume:
        if not os.path.exists(fed.checkpoint_path):
            warnings.warn(f"resume: no checkpoint at "
                          f"{fed.checkpoint_path!r} — starting from round 0 "
                          f"(checkpoints will be written there)")
        else:
            (pop, s_model, l0, a0, w0, start, adm0,
             acc0) = fed_engine._load_state(fed, store.population, s_model,
                                            m, adm_state, robust)
            store.load(pop)
            bank, ef_bank = build_banks()    # bank rows = current Cs
            adm_state = adm0 if adm0 is not None else adm_state
            if robust:
                hist_acc_rows = [np.asarray(row, bool) for row in acc0]
            hist_loss = [float(v) for v in l0]
            hist_accs = [list(map(float, row)) for row in a0]
            hist_wall = [float(v) for v in w0]
            # fast-forward every per-client stream over the done rounds
            for _ in range(start):
                for ld in loaders:
                    ld.skip(fed.local_steps)
            if verbose:
                print(f"[{strategy.name}] resumed {start} rounds "
                      f"from {fed.checkpoint_path}")

    def round_stats(rnd: int, plan, accept_row) -> tuple:
        """(n_up, n_down, rejected ids, failed ids) of a round; the
        fault-free values when ``robust`` is off."""
        if not robust:
            return (plan.n_participants, plan.n_participants, [], [])
        pm = plan.mask(m)
        if fm.active:
            fd = fdraws[rnd]
            sent = pm & ~fd.crash
            delivered = sent & ~fd.loss
            failed = np.nonzero(pm & (fd.crash | fd.loss))[0].tolist()
        else:
            sent = delivered = pm
            failed = []
        acc = np.asarray(accept_row, bool)
        n_down = int(acc.sum()) if communicates else plan.n_participants
        return (int(sent.sum()), n_down,
                np.nonzero(delivered & ~acc)[0].tolist(), failed)

    def record(rnd: int, plan, loss: float, accs: list, wall: float,
               accept_row, host_s: float = 0.0, device_s: float = 0.0,
               ) -> RoundRecord:
        n_up, n_down, rejected, failed = round_stats(rnd, plan, accept_row)
        return RoundRecord(
            rnd, loss, accs, uplink_bytes=per_b * n_up,
            downlink_bytes=per_down_b * n_down, wall_s=wall,
            participants=plan.participants.tolist(),
            sampled=plan.sampled.tolist(), dropped=plan.dropped.tolist(),
            uplink_elems=per_e * n_up, host_s=host_s, device_s=device_s,
            evaluated=_do_eval(rnd, fed), rejected=rejected, failed=failed)

    history = [record(rnd, plans[rnd], hist_loss[rnd], hist_accs[rnd],
                      hist_wall[rnd],
                      hist_acc_rows[rnd] if robust else None)
               for rnd in range(start)]

    accs = hist_accs[-1][:] if start else [0.0] * m
    rounds_left = list(range(start, fed.rounds))

    def produce(rnd: int):
        return client_batch.stack_cohort_batches(
            loaders, plans[rnd].sampled, fed.local_steps, device=dev)

    prefetcher = None
    if scan_engine and fed.scan_prefetch and rounds_left:
        order = iter(rounds_left)
        prefetcher = client_batch.ChunkPrefetcher(
            lambda _n: produce(next(order)), [1] * len(rounds_left))
    try:
        for rnd in rounds_left:
            plan = plans[rnd]
            t0 = time.perf_counter()
            batches = (prefetcher.get()[0] if prefetcher is not None
                       else produce(rnd))
            t_fetch = time.perf_counter()
            toks, labs = client_batch.to_device(batches, dev)
            # the gather lands every write-back of the rounds before: the
            # cohort sees the population as of the last completed round
            cohort = store.gather(plan.cohort)
            x = {"toks": toks, "labs": labs, "cids_np": plan.sampled,
                 **client_batch.to_device({
                     "pml": client_batch.host_tensor(plan.cohort_mask(), dev),
                     "pmf": client_batch.host_tensor(plan.mask(m), dev),
                     "cids": client_batch.host_tensor(
                         plan.sampled.astype(np.int64), dev)}, dev)}
            if fm.active:
                fd = fdraws[rnd]
                x.update(client_batch.to_device(
                    {ev: client_batch.host_tensor(
                        getattr(fd, ev)[plan.sampled], dev)
                     for ev in faults.FAULT_EVENTS}, dev))
            cohort, bank, ef_bank, s_model, adm_state, loss, accept_l = step(
                cohort, bank, ef_bank, s_model, adm_state, x, rnd)
            store.scatter(plan.cohort, cohort)
            loss = float(loss)                  # the round's host sync
            accept_row = None
            if robust:
                accept_row = np.zeros(m, bool)
                accept_row[plan.sampled] = accept_l.cpu().numpy()
                hist_acc_rows.append(accept_row)
            del cohort
            if _do_eval(rnd, fed):
                accs = eval_population()
            t_done = time.perf_counter()
            hist_loss.append(loss)
            hist_accs.append(list(accs))
            hist_wall.append(t_done - t0)
            history.append(record(rnd, plan, loss, list(accs), t_done - t0,
                                  accept_row, host_s=t_fetch - t0,
                                  device_s=t_done - t_fetch))
            if verbose:
                _print_round(strategy, history[-1])
            if scan_engine and fed.checkpoint_path and \
                    ((rnd + 1 - start) % chunk == 0 or rnd == fed.rounds - 1):
                # the scan engine's file: the same tree keys and metadata
                fed_engine._save_state(
                    fed, store.population, s_model, hist_loss, hist_accs,
                    hist_wall, rnd + 1, strategy, adm_state=adm_state,
                    accepts=np.stack(hist_acc_rows) if robust else None)
    finally:
        if prefetcher is not None:
            prefetcher.close()

    resident = [t for t in tree_leaves((bank, ef_bank, s_model))
                if isinstance(t, torch.Tensor)]
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
        "states": store.unstack(),
        "device_resident_bytes": sum(t.numel() * t.element_size()
                                     for t in resident),
    }
