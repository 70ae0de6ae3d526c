"""The scan engine, ``FedConfig.engine="scan"``: PyTorch port of
``repro.core.fed_engine``.

The eager engine runs Algorithm 1's outer loop round by round, with host
syncs inside every round (the plan masks, the byte ledger, the admission
decisions and the history are read on the host as the round goes).  This
engine runs ONE FULL ROUND as one Python function over the stacked state

    local fit of all m clients → participation select → uplink → masked
    S^model row refresh → eqn-(3) personalized aggregation (or FedAvg) →
    masked install → eval on cadence

and drives it over CHUNKS of rounds with exactly one host sync per chunk:

* the chunk's participation plans (:func:`.sampling.stack_plans`), fault
  draws and the codec's uniforms are built once per chunk as device
  tensors; each round reads one row of them;
* the chunk's minibatches are drawn as ``(chunk, m, local_steps, B, T)``
  host tensors (:func:`.client_batch.stack_chunk_batches`, pinned on a
  card, drawn on a thread while the previous chunk computes) and moved by
  one ``non_blocking`` copy each;
* the loss, the accuracies and the admission decisions accumulate in
  device tensors, read back once at the end of the chunk;
* bytes are priced on the host from the plan's counts times per-client
  constants reckoned on meta tensors (:func:`.comm.per_client_comm`), and
  the eval cadence is the host-known round index.

In the JAX package the chunk is one jitted ``lax.scan`` of ``round_step``;
here it is one cached program too (:mod:`.jit_cache`, ``_SCAN_CACHE``): on
a card ONE CUDA GRAPH A CHUNK, every round's fit, select, uplink, S^model
refresh, aggregation, install and eval captured together and replayed
with no Python between launches (the fit and eval programs that
``run_federated`` hands over run plain inside the capture).  Its inputs
are the chunk's batches, plan and fault rows and codec uniforms, and the
run's constants (test stacks, S^data, CKA probes, sample counts); it
returns the carry and the chunk's (loss, accuracies, accepts) rows, read
back once.  With ``scan_donate`` the carry is donated: the graph writes
the new carry over the old one in place.  The cache key is the JAX
package's, plus the chunk length (the odd last chunk is a program of its
own, as JAX retraces by shape) and the chunk's eval-cadence pattern (the
port's cadence is the host's round index, where JAX takes a ``lax.cond``):
with ``eval_every=1`` a run builds one program per chunk length, and the
cache grows to hold every pattern a run meets, so none is captured twice
(each holds a graph's memory pool: a cadence prime to the chunk length
costs up to chunk + 2 of them).  On the
CPU the program is the chunk function itself, so a captured chunk is the
eager chunk, op for op.

Equivalence contract (the JAX package's, tests/test_fed_engine.py): the
same ``FedConfig`` (minus ``engine``) reproduces the eager history — loss
and accuracy close, sampled / participant sets and bytes identical.  The
S^model carry starts from the full pairwise CKA of the initial Cs and each
round refreshes only the sampled rows and columns.

Checkpoint and resume: at every chunk boundary the stacked client states
(error-feedback residual included), the S^model carry, the admission
gate's ring and the history are written through :mod:`repro_torch.
checkpoint` in the JAX package's tree keys and metadata, with the run
fingerprint.  ``FedConfig.resume=True`` restores it (either package's),
fast-forwards the per-client data streams (``Loader.skip``) and continues,
reproducing the uninterrupted run.  ``scan_donate`` releases the old
carry's storage after each chunk (:func:`.client_batch.release`);
``scan_prefetch`` draws the next chunk on a thread; ``RoundRecord.host_s``
/ ``device_s`` split the wall time.
"""
from __future__ import annotations

import functools
import os
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import (admission, aggregation, client_batch,
                              client_store, compress, faults, jit_cache,
                              sampling, tri_lora)
from repro_torch.core.similarity import cka
from repro_torch.tree import tree_map

# The chunk programs, anchored on the task's backbone and config: a CUDA
# graph a (key, chunk length, cadence pattern) on a card
_SCAN_CACHE = jit_cache.JitCache(maxsize=8)

# Checkpoints written before fault injection and admission existed carry
# none of these knobs; they were written by the fault-free runtime, which
# is what these defaults assert (the JAX package's constant).
ROBUSTNESS_DEFAULTS = {
    "fault_crash": 0.0, "fault_loss": 0.0, "fault_corrupt": 0.0,
    "fault_corrupt_mode": "nan", "fault_divergent": 0.0,
    "fault_divergent_scale": 1e4, "admission": "none",
    "admission_norm_mult": 10.0, "admission_window": 8,
}

# FedConfig fields that must match between a checkpoint and the run that
# resumes from it: each changes the per-round math, the plans or the
# meaning of the stored state (the EF residual is meaningful only under the
# codec that produced it).  The JAX package's tuple, field for field.
_FINGERPRINT_FIELDS = ("method", "n_clients", "rounds", "local_steps",
                       "batch_size", "lr", "seed", "participation",
                       "sampler", "straggler_frac", "use_data_sim",
                       "use_model_sim", "cka_probes", "self_weight",
                       "pfedme_eta", "uplink_codec", "eval_every",
                       "client_store", "attn_impl",
                       ) + tuple(ROBUSTNESS_DEFAULTS)

# what checkpoints written before a field existed stand for
_BACKFILL = dict({"uplink_codec": "none", "eval_every": 1,
                  "client_store": "device", "attn_impl": "auto"},
                 **ROBUSTNESS_DEFAULTS)


def _fingerprint(fed) -> dict:
    fp = {f: getattr(fed, f) for f in _FINGERPRINT_FIELDS}
    if fp["attn_impl"] is None:       # a direct engine call skips
        fp["attn_impl"] = "auto"      # run_federated's resolution
    return fp


def _save_state(fed, stacked, s_model, losses, accs, walls,
                rounds_done: int, strategy, adm_state=None,
                accepts=None) -> None:
    tree = {"state": stacked,
            "loss": np.asarray(losses, np.float32),
            "accs": np.asarray(accs, np.float32),
            "wall": np.asarray(walls, np.float32)}
    if s_model is not None:
        tree["s_model"] = s_model
    if adm_state is not None:
        # the gate's median ring rides the carry: a resume in the middle of
        # a fault storm must reproduce the admission decisions
        tree["admission"] = adm_state
    if accepts is not None:
        tree["accept"] = np.asarray(accepts, bool)
    ckpt.save(fed.checkpoint_path, tree,
              metadata=dict(_fingerprint(fed), engine="scan",
                            strategy=strategy.name, rounds_done=rounds_done))


def _load_state(fed, stacked, s_model, m: int, adm_state=None,
                robust: bool = False):
    """Restore a chunk-boundary checkpoint into (stacked, s_model, loss,
    accs, wall, rounds_done, adm_state, accept history), on the devices
    and in the dtypes of the templates, after checking the fingerprint."""
    meta = ckpt.metadata(fed.checkpoint_path)
    if "rounds_done" not in meta:
        raise ValueError(f"{fed.checkpoint_path!r} is not a scan-engine "
                         f"checkpoint (no rounds_done in metadata)")
    ckpt.check_fingerprint(fed.checkpoint_path, meta, _fingerprint(fed),
                           defaults=_BACKFILL, ignore=("rounds",))
    rounds_done = int(meta["rounds_done"])
    if rounds_done > fed.rounds:
        raise ValueError(f"checkpoint has {rounds_done} completed rounds "
                         f"but the run asks for only {fed.rounds}")
    like = {"state": stacked,
            "loss": np.zeros((rounds_done,), np.float32),
            "accs": np.zeros((rounds_done, m), np.float32),
            "wall": np.zeros((rounds_done,), np.float32)}
    if s_model is not None:
        like["s_model"] = s_model
    if adm_state is not None:
        like["admission"] = adm_state
    if robust:
        like["accept"] = np.zeros((rounds_done, m), bool)
    tree = ckpt.restore(fed.checkpoint_path, like)
    return (tree["state"], tree.get("s_model"), tree["loss"], tree["accs"],
            tree["wall"], rounds_done, tree.get("admission"),
            tree.get("accept"))


def chunk_schedule(start: int, rounds: int, chunk: int) -> list:
    """The (c0, c1) round ranges of the chunks from ``start`` on."""
    return [(c0, min(c0 + chunk, rounds))
            for c0 in range(start, rounds, chunk)]


def meta_like(tree):
    """``tree`` as meta tensors: shapes and dtypes, no data, no device."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def run_scan(*, task, fed, strategy, states: list, loaders: Sequence,
             sample_counts: Sequence[int],
             plans: Sequence[sampling.ParticipationPlan],
             local_fit: Callable, eval_acc: Callable,
             s_data: Optional[torch.Tensor],
             test_toks: torch.Tensor, test_labs: torch.Tensor,
             cka_probes: Optional[torch.Tensor],
             sr_uniforms: Optional[Callable], device, anchors: tuple,
             verbose: bool = False) -> dict:
    """The scan-engine body of ``run_federated`` (module docstring), called
    after its shared setup: ``local_fit(trainable, w_ref, toks, labs) →
    (trainable, (m,) losses)`` over the stacked state, ``eval_acc(
    trainable, test_toks, test_labs) → (m,)`` accuracies as a tensor,
    ``sr_uniforms(round, client)`` the codec's uniform source,
    ``anchors`` what the chunk programs are cached on (``run_federated``'s
    fit and eval anchors: its caller's backbone and config).  Returns
    ``run_federated``'s result dict."""
    from repro_torch.core.federated import RoundRecord   # late: a cycle

    dev = torch.device(device)
    m = fed.n_clients
    chunk = max(1, int(fed.chunk_rounds))
    eval_every = max(1, int(fed.eval_every))

    # the scan engine always runs the stacked clients; the store places the
    # population ("loop" and "vmap" keep it on the device alike, "shard"
    # and "sharded" lay it over the client mesh)
    pstore = client_store.make_store(fed.client_store, states,
                                     parallelism=fed.client_parallelism,
                                     device=dev)
    stacked = pstore.resident()

    pstack = sampling.stack_plans(plans, m)
    codec = compress.get_codec(fed.uplink_codec)
    communicates = strategy.aggregate != "none"
    compressed = not codec.is_identity and communicates
    draws_uniforms = compressed and codec.qmax is not None

    # the fault schedule drawn on the host for every round (the eager
    # engine's per-round draws) and the admission gate's state
    fm = faults.fault_model_of(fed)
    adm = admission.control_of(fed)
    robust = fm.active or adm.enabled
    fstack = None
    if fm.active:
        draws = [fm.draw(m, rnd, fed.seed) for rnd in range(fed.rounds)]
        fstack = {ev: np.stack([getattr(d, ev) for d in draws])
                  for ev in faults.FAULT_EVENTS}
        sent_np = pstack.participant_mask & ~fstack["crash"]
        delivered_np = sent_np & ~fstack["loss"]
    else:
        sent_np = delivered_np = pstack.participant_mask
    adm_state = admission.init_state(adm.window, dev) if adm.enabled else None

    # per-client byte constants from shapes alone: the uplink priced on the
    # ENCODED tree, the downlink on the raw payload
    payload_struct = strategy.uplink(meta_like(stacked))
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
    # S^model carry: the full pairwise CKA of the INITIAL Cs, the state the
    # eager row-refresh cache starts from
    s_model = None
    if use_model:
        s_model = cka.pairwise_model_similarity_stacked(
            tri_lora.tree_payload(stacked["adapter"]), cka_probes)
    counts = torch.as_tensor(np.asarray(sample_counts, np.float32),
                             device=dev)           # a per-run constant

    # ---- resume from a chunk-boundary checkpoint
    hist_loss: list = []
    hist_accs: list = []
    hist_wall: list = []
    hist_host: list = []
    hist_dev: list = []
    hist_accept: list = []
    start = 0
    if fed.checkpoint_path and fed.resume and \
            not os.path.exists(fed.checkpoint_path):
        warnings.warn(f"resume: no checkpoint at {fed.checkpoint_path!r} — "
                      f"starting from round 0 (checkpoints will be written "
                      f"there)")
    if fed.checkpoint_path and fed.resume and \
            os.path.exists(fed.checkpoint_path):
        (stacked, s_model, l0, a0, w0, start, adm0,
         acc0) = _load_state(fed, stacked, s_model, m, adm_state, robust)
        pstore.adopt(stacked)
        if adm0 is not None:
            adm_state = adm0
        if acc0 is not None:
            hist_accept = [np.asarray(row, bool) for row in np.asarray(acc0)]
        hist_loss = [float(v) for v in l0]
        hist_accs = [list(map(float, row)) for row in a0]
        hist_wall = [float(v) for v in w0]
        hist_host = [0.0] * start
        hist_dev = [0.0] * start
        # fast-forward the per-client streams: round `start` then draws
        # what the uninterrupted run drew (no batch is materialized)
        for _ in range(start):
            for ld in loaders:
                ld.skip(fed.local_steps)
        if verbose:
            print(f"[{strategy.name}] resumed {start} rounds "
                  f"from {fed.checkpoint_path}")

    # the accuracies ride the carry, so that an off-cadence round repeats
    # the last evaluated row; on resume that is the last history row
    accs0 = (torch.tensor(hist_accs[-1], dtype=torch.float32, device=dev)
             if start else torch.zeros((m,), dtype=torch.float32,
                                       device=dev))
    carry = (stacked, s_model, accs0, adm_state)

    def round_step(carry, toks, labs, x: dict, u, consts: dict,
                   do_eval: bool):
        """One round on the device: no read-back, every input a device
        tensor (``x``: this round's rows of the chunk's masks and ids,
        ``u``: the codec's uniforms per payload leaf, ``consts``: the
        run's constants); ``do_eval`` is the round's cadence."""
        stacked, s_model, prev_accs, adm_state = carry
        smask, pmask = x["smask"], x["pmask"]
        tr, losses = local_fit(strategy.trainable(stacked),
                               stacked.get("w", {}), toks, labs)
        prev = dict(stacked)
        new = strategy.after_local(dict(stacked, **tr), fed.pfedme_eta)
        sel = smask
        if fm.active:
            # crash: the round's local work is lost; divergent: the
            # client's divergence detection resets to the round start
            sel = smask & ~x["crash"] & ~x["divergent"]
        stacked = client_batch.select_clients(sel, new, prev)

        payload = strategy.uplink(stacked)
        if fm.active and communicates and fm.divergent > 0:
            # the divergent upload is the blowup the norm gate must catch
            payload = faults.scale_rows(payload, smask & x["divergent"],
                                        fm.divergent_scale)
        if fm.active:
            delivered = pmask & ~x["crash"] & ~x["loss"]
        else:
            delivered = pmask
        enc = None
        if compressed:
            # error-compensated uplink: the residual rides the stacked
            # state, the server consumes the DEQUANTIZED payload
            enc, dec, ef_new = compress.encode_stacked(
                codec, payload, stacked["ef"], uniforms=u)
            if not robust:
                stacked = dict(stacked, ef=client_batch.select_clients(
                    pmask, ef_new, stacked["ef"]))
            served = dec
        else:
            served = payload
        if fm.active and communicates and fm.corrupt > 0:
            served = faults.corrupt_served(
                codec if compressed else None, enc, served,
                delivered & x["corrupt"], fm.corrupt_mode)
        accept = delivered
        if robust and communicates:
            if adm.enabled:
                norms, finite = admission.payload_stats(served)
                accept, adm_state = admission.admit(norms, finite, delivered,
                                                    adm_state, adm)
            if compressed:
                # EF advances only for ACCEPTED uploads: a rejection rolls
                # the residual back by never installing the new one
                stacked = dict(stacked, ef=client_batch.select_clients(
                    accept, ef_new, stacked["ef"]))
        agg_mask = accept if robust and communicates else pmask
        weights = None
        if personalized:
            sims = [consts["s_data"]] if use_data else []
            if use_model:
                cs = cka.stacked_cs(
                    served if compressed or robust
                    else tri_lora.tree_payload(stacked["adapter"]))
                refreshed = cka.refresh_rows_inline(s_model, cs, x["ids"],
                                                    consts["probes"])
                if robust:
                    # refresh only ACCEPTED rows: a pair touching a sampled
                    # client whose upload was not accepted keeps its entry
                    clean = ~smask | accept
                    valid = ((accept[:, None] & clean[None, :])
                             | (accept[None, :] & clean[:, None]))
                    s_model = torch.where(valid, refreshed, s_model)
                else:
                    s_model = refreshed
                sims.append(s_model)
            weights = aggregation.personalized_weights(
                sum(sims), fed.self_weight, agg_mask)
        if robust and communicates:
            # rejected or undelivered rows may hold NaN/Inf: their weight
            # is 0, but 0 x NaN still poisons the mix
            served = faults.zero_rows(served, accept)
        down = strategy.server_stacked(served,
                                       sample_counts=consts["counts"],
                                       weights=weights,
                                       participants=agg_mask)
        if down is not None:
            stacked = client_batch.select_clients(
                agg_mask, strategy.install(stacked, down), stacked)

        # the cadence is the host's round index: off-cadence rounds carry
        # the last evaluated accuracies
        if do_eval:
            accs = eval_acc(strategy.trainable(stacked), consts["test_toks"],
                            consts["test_labs"])
        else:
            accs = prev_accs
        sm = smask.to(losses.dtype)
        loss = torch.sum(losses * sm) / torch.clamp_min(torch.sum(sm), 1.0)
        return (stacked, s_model, accs, adm_state), (loss, accs, accept)

    def chunk_fn(evals: tuple, carry, toks, labs, x: dict, u, consts: dict):
        """The chunk program: ``round_step`` for each round of the chunk
        (``evals``: which rounds evaluate) → (carry, (rounds, 1 + 2m)
        rows of loss, accuracies and accepts)."""
        ys = []
        for j, do_eval in enumerate(evals):
            carry, y = round_step(carry, toks[j], labs[j],
                                  {k: v[j] for k, v in x.items()},
                                  [l[j] for l in u] if u else None, consts,
                                  do_eval)
            ys.append(y)
        return carry, torch.cat(
            [torch.stack([y[0] for y in ys])[:, None].float(),
             torch.stack([y[1] for y in ys]).float(),
             torch.stack([y[2] for y in ys]).float()], dim=1)

    # the JAX package's key: what shapes the traced program and is not a
    # tensor input (the seed is not: the codec's uniforms are inputs here;
    # nor is scan_donate: jit keys on the donated arguments itself)
    scan_key = ("scan", strategy.name, fed.lr, fed.local_steps,
                fed.batch_size, fed.pfedme_eta, fed.self_weight, use_data,
                use_model, fed.client_parallelism, fed.attn_impl,
                fed.uplink_codec, fed.fault_crash, fed.fault_loss,
                fed.fault_corrupt, fed.fault_corrupt_mode,
                fed.fault_divergent, fed.fault_divergent_scale,
                fed.admission, fed.admission_norm_mult,
                fed.admission_window)
    consts = {"counts": counts, "test_toks": test_toks,
              "test_labs": test_labs, "s_data": s_data if use_data else None,
              "probes": cka_probes if use_model else None}

    def evaluates(rnd: int) -> bool:
        return rnd % eval_every == 0 or rnd == fed.rounds - 1

    rows_np = {"smask": pstack.sampled_mask, "pmask": pstack.participant_mask,
               "ids": pstack.sampled_ids, **(fstack or {})}
    next_round = [start]

    def produce(n_rounds: int):
        """A chunk's host inputs, in schedule order: the batches and the
        codec's uniforms per payload leaf, (n_rounds, m, …) each."""
        r0 = next_round[0]
        next_round[0] += n_rounds
        toks, labs = client_batch.stack_chunk_batches(
            loaders, n_rounds, fed.local_steps, device=dev)
        u = None
        if draws_uniforms:
            per_round = [compress.stacked_uniforms(
                codec, payload_struct, [sr_uniforms(r, i) for i in range(m)])
                for r in range(r0, r0 + n_rounds)]
            u = [client_batch.host_tensor(torch.stack(leaf), dev)
                 for leaf in zip(*per_round)]
        return toks, labs, u

    def dispatch(carry, batches, c0, c1):
        toks, labs, u = client_batch.to_device(batches, dev)
        # each chunk's rows copied out of the run's arrays: a slice's
        # offset would change the program's signature from chunk to chunk
        x = client_batch.to_device(
            {k: client_batch.host_tensor(v[c0:c1].copy(), dev)
             for k, v in rows_np.items()}, dev)
        evals = tuple(evaluates(r) for r in range(c0, c1))
        run_chunk = jit_cache.jit(
            _SCAN_CACHE, anchors, scan_key + (c1 - c0, evals),
            functools.partial(chunk_fn, evals),
            donate_argnums=(0,) if fed.scan_donate else ())
        carry, rows = run_chunk(carry, toks, labs, x, u, consts)
        # the chunk's ONE host sync: loss, accuracies and accept rows
        return carry, rows.cpu().numpy()

    def on_chunk(carry, c0, c1, out, host_s, device_s, wall_s):
        n = c1 - c0
        hist_loss.extend(float(v) for v in out[:, 0])
        hist_accs.extend(list(map(float, row)) for row in out[:, 1:1 + m])
        if robust:
            hist_accept.extend(row > 0.5 for row in out[:, 1 + m:])
        hist_wall.extend([wall_s] * n)
        hist_host.extend([host_s] * n)
        hist_dev.extend([device_s] * n)
        if fed.checkpoint_path:
            _save_state(fed, carry[0], carry[1], hist_loss, hist_accs,
                        hist_wall, c1, strategy, adm_state=carry[3],
                        accepts=np.stack(hist_accept) if robust else None)
        if verbose:
            print(f"[{strategy.name}] rounds {c0:3d}–{c1 - 1:3d} "
                  f"loss {hist_loss[-1]:.4f} "
                  f"acc {float(np.mean(hist_accs[-1])):.3f} "
                  f"({wall_s:.2f}s/round)")

    schedule = chunk_schedule(start, fed.rounds, chunk)
    # the cache holds every (length, cadence) program the run replays: an
    # eval_every prime to the chunk length meets up to chunk + 1 patterns
    # besides the last chunk's, and an LRU smaller than that would capture
    # again on almost every chunk
    patterns = {(c1 - c0, tuple(evaluates(r) for r in range(c0, c1)))
                for c0, c1 in schedule}
    _SCAN_CACHE.maxsize = max(_SCAN_CACHE.maxsize, len(patterns))
    carry = client_batch.drive_chunks(
        carry, schedule, produce, dispatch,
        on_chunk, donate=fed.scan_donate, prefetch=fed.scan_prefetch)
    # a donated carry is the chunk program's buffer: the states returned
    # get storage of their own before another run replays into it
    pstore.adopt(jit_cache.unshared(carry[0]))

    def n_up(rnd: int) -> int:
        # robust runs price the uploads that left a device (a crashed
        # client sends nothing; a lost or rejected one did pay)
        return (int(sent_np[rnd].sum()) if robust
                else int(pstack.n_participants[rnd]))

    def n_down(rnd: int) -> int:
        return (int(np.sum(hist_accept[rnd])) if robust and communicates
                else int(pstack.n_participants[rnd]))

    history = [
        RoundRecord(
            rnd, hist_loss[rnd], hist_accs[rnd],
            uplink_bytes=per_b * n_up(rnd),
            downlink_bytes=per_down_b * n_down(rnd),
            wall_s=hist_wall[rnd],
            participants=plans[rnd].participants.tolist(),
            sampled=plans[rnd].sampled.tolist(),
            dropped=plans[rnd].dropped.tolist(),
            uplink_elems=per_e * n_up(rnd),
            host_s=hist_host[rnd], device_s=hist_dev[rnd],
            evaluated=evaluates(rnd),
            rejected=(np.nonzero(delivered_np[rnd] & ~hist_accept[rnd])[0]
                      .tolist() if robust and communicates else []),
            failed=(np.nonzero(pstack.participant_mask[rnd]
                               & (fstack["crash"][rnd] | fstack["loss"][rnd])
                               )[0].tolist() if fm.active else []))
        for rnd in range(fed.rounds)]

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
        "states": pstore.unstack(),
    }
