"""Federated training driver (the end-to-end launcher): PyTorch port of
``repro.launch.train``, the eager engine's ``loop`` and ``vmap`` paths.

Runs CE-LoRA federated fine-tuning of a causal-LM backbone on synthetic
Zipf-Markov data split across simulated clients:

    python -m repro_torch.launch.train --arch fed-100m --reduced \\
        --clients 3 --rounds 2 --local-steps 3 --batch 4 --seq 64 \\
        --device cpu                                  # tiny, plain path
    python -m repro_torch.launch.train --arch fed-100m --clients 4 \\
        --rounds 3 --local-steps 5 --batch 8 --seq 256 --attn-impl flash
                                                      # full width, the card

Per round each sampled client runs ``local_steps`` AdamW steps on its own
stream (a fresh optimizer state per round, as in the JAX package); the
participants uplink their payload — C for CE-LoRA, the whole adapter for
FedAvg, nothing for ``local`` — optionally through an uplink codec with
error feedback (:mod:`repro_torch.core.compress`); the server mixes by
eqn (3) over CKA similarities (CE-LoRA) or averages (FedAvg), and the
participants install the result.  Bytes are exact: the ENCODED uplink and
the raw downlink.  With ``ckpt`` the run ends by saving client 0's adapter
(:mod:`repro_torch.checkpoint`, the JAX package's file layout).

On CUDA every adapted projection runs the tri-LoRA kernels
(``models.layers.dense``) and ``attn_impl="flash"`` the flash kernels.
``client_parallelism="vmap"`` (the default, as in the JAX package) trains
all clients as one batch: their adapters stacked (leaves (m, …)), their
batches folded into one of m·B sequences that each apply their own
client's adapter (the grouped tri-LoRA kernels on the card), the SUM of
the m per-client losses differentiated, and the server steps on the
stacked payload; ``"loop"`` trains the clients one after another.

``engine="scan"`` (on vmap) runs the same rounds in chunks of
``chunk_rounds`` with one host sync per chunk (as
:mod:`repro_torch.core.fed_engine` does for ``run_federated``): with
``ckpt`` it writes the stacked adapters, the error-feedback residual and
the history to that file at every chunk boundary (the JAX package's tree
keys and metadata), and ``resume`` restores it, fast-forwards the data
streams and continues, reproducing the uninterrupted run:

    python -m repro_torch.launch.train --arch fed-100m --reduced \
        --clients 2 --rounds 4 --engine scan --chunk-rounds 2 \
        --ckpt /tmp/lm.npz --device cpu
    python -m repro_torch.launch.train ... --rounds 8 --resume

``client_store="host"`` (eager, vmap) keeps the m adapters in host
memory and brings each round's sampled cohort to the device; for CE-LoRA
a device bank of every client's C payload (and its error-feedback
residual) backs the all-m CKA.  ``engine="async"`` (vmap, device store)
runs the buffered server of :mod:`repro_torch.core.async_engine`: clients
dispatch in plan order, arrive on the seeded virtual clock
(``latency`` / ``latency_scale`` / ``latency_sigma``), and every
``buffer_size`` arrivals the server aggregates with the
``staleness_decay`` discount; at uniform latency with the buffer the
cohort size it is the eager driver's history:

    python -m repro_torch.launch.train --arch fed-100m --reduced \
        --clients 4 --participation 0.5 --client-store host --device cpu
    python -m repro_torch.launch.train --arch fed-100m --reduced \
        --clients 4 --engine async --latency lognormal --buffer-size 2 \
        --staleness-decay 0.5 --device cpu

``client_store="sharded"`` (vmap; eager and scan) lays the stacked
adapters over the ``("clients",)`` device mesh in d row blocks
(:class:`repro_torch.core.client_store.ShardedClientStore`); the rounds
compute on the run's device, so on one card (d = 1) it is the device
store exactly.

The random draws the JAX package takes from ``jax.random`` — the backbone
(``key(seed)``), client ``i``'s adapter (``key(seed + i)``), the CKA probes
(``key(seed + 99)``) and the stochastic rounding (``client_key``) — come
from generators seeded the same way, or ready-made from the caller
(``base``, ``init_adapters``, ``cka_probes``, ``sr_uniforms``).
"""
from __future__ import annotations

import argparse
import functools
import os
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import (check_fingerprint, metadata, restore,
                                    save)
from repro_torch.core import (aggregation, client_batch, client_store,
                              comm, compress, jit_cache, sampling, tri_lora)
from repro_torch.core.client_store import ShardedClientStore
from repro_torch.core.fed_engine import chunk_schedule, meta_like
from repro_torch.core.similarity import cka
from repro_torch.data import synthetic
from repro_torch.device import check_on, resolve_device
from repro_torch.models import attention, model, transformer
from repro_torch.models.config import get_config
from repro_torch.optim import adamw, apply_updates
from repro_torch.tree import tree_leaves, tree_map

METHODS = ("celora", "fedavg", "local")
CKA_PROBES = 32


def _validate(clients: int, participation: float, straggler_frac: float,
              method: str, client_parallelism: str, engine: str,
              client_store_name: str, resume: bool,
              latency: tuple) -> None:
    """The JAX package's checks, in its order."""
    if client_parallelism not in ("loop", "vmap"):
        raise ValueError(f"client_parallelism={client_parallelism!r}; "
                         f"expected 'loop' or 'vmap'")
    if engine not in ("eager", "scan", "async"):
        raise ValueError(f"engine={engine!r}; "
                         f"expected 'eager', 'scan', or 'async'")
    if engine in ("scan", "async") and client_parallelism != "vmap":
        raise ValueError(f"engine={engine!r} runs on the stacked client "
                         f"axis; use client_parallelism='vmap'")
    if engine == "async":
        if resume:
            raise ValueError("resume is not supported by the LM driver's "
                             "async engine (run_federated's async engine "
                             "resumes)")
        if straggler_frac > 0.0:
            raise ValueError("engine='async' replaces the straggler drop "
                             "mask with the latency model; set "
                             "straggler_frac=0")
        if client_store_name != "device":
            raise ValueError("engine='async' requires client_store='device'")
        sampling.LatencyModel(*latency)              # validates
    if client_store_name not in client_store.STORE_BACKENDS:
        raise ValueError(f"client_store={client_store_name!r}; expected one "
                         f"of {client_store.STORE_BACKENDS}")
    if client_store_name != "device" and client_parallelism != "vmap":
        raise ValueError(f"client_store={client_store_name!r} requires "
                         f"client_parallelism='vmap'")
    if client_store_name == "host" and engine != "eager":
        raise ValueError("the LM driver's host-backed store runs eager "
                         "rounds only; use engine='eager' or "
                         "client_store='device'/'sharded'")
    if resume and engine != "scan":
        raise ValueError("resume requires engine='scan' (the eager driver "
                         "does not write resumable state)")
    if method not in METHODS:
        raise ValueError(f"method={method!r}; expected one of {METHODS}")
    sampling.n_sampled(clients, participation)       # validates
    if not 0.0 <= straggler_frac < 1.0:
        raise ValueError(f"straggler_frac must be in [0, 1); "
                         f"got {straggler_frac}")


# The LM driver's fit programs (the JAX package jits them per run): on a
# card a CUDA graph a signature, anchored on the backbone and its config,
# keyed on the path and the optimizer (its step's scalars are baked into
# the graph); a graph holds device memory, so the bound is small.
_FIT_CACHE = jit_cache.JitCache(maxsize=4)


def local_fit(cfg, base: dict, opt, adapter: dict, toks: torch.Tensor,
              labs: torch.Tensor):
    """One client's local fit: an AdamW step (a fresh optimizer state, as
    in the JAX package) per (B, S) batch of the stacked ``toks`` /
    ``labs``, the causal-LM loss on the frozen ``base``.  Returns the
    adapter and each step's loss.  Runs the cached program
    (:mod:`repro_torch.core.jit_cache`)."""
    return jit_cache.jit(_FIT_CACHE, (base, cfg), ("one", opt),
                         functools.partial(_local_fit, cfg, base, opt))(
        adapter, toks, labs)


def local_fit_stacked(cfg, base: dict, opt, stacked: dict,
                      toks: torch.Tensor, labs: torch.Tensor):
    """All clients' :func:`local_fit` as one batch: ``stacked`` adapters
    (leaves (m, …)), ``toks`` / ``labs`` (m, steps, B, S), ``opt`` an
    ``adamw(stacked=True)``.  Each step folds the m batches into one of
    m·B sequences and differentiates the SUM of the m per-client losses,
    so each client gets exactly its own gradient.  Returns the adapters
    and each client's step losses (m, steps).  Runs the cached program."""
    return jit_cache.jit(_FIT_CACHE, (base, cfg), ("stacked", opt),
                         functools.partial(_local_fit_stacked, cfg, base,
                                           opt))(stacked, toks, labs)


def _local_fit(cfg, base: dict, opt, adapter: dict, toks: torch.Tensor,
               labs: torch.Tensor):
    """The body of :func:`local_fit`."""
    state = opt.init(adapter)
    losses = []
    for step in range(toks.shape[0]):
        ad = tree_map(lambda t: t.detach().requires_grad_(True), adapter)
        loss, _ = model.loss_fn(cfg, ad, base, {"tokens": toks[step],
                                                "labels": labs[step]})
        leaves = tree_leaves(ad)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        upd, state = opt.update(tree_map(lambda t: grads[id(t)], ad), state,
                                adapter)
        adapter = apply_updates(adapter, upd)
        losses.append(loss.detach())
    return adapter, torch.stack(losses)


def _local_fit_stacked(cfg, base: dict, opt, stacked: dict,
                       toks: torch.Tensor, labs: torch.Tensor):
    """The body of :func:`local_fit_stacked`."""
    m, b = toks.shape[0], toks.shape[2]
    rows = model.client_rows(m, b, toks.device)
    state = opt.init(stacked)
    losses = []
    for step in range(toks.shape[1]):
        ad = tree_map(lambda t: t.detach().requires_grad_(True), stacked)
        loss, _ = model.loss_fn(
            cfg, ad, base, {"tokens": toks[:, step].flatten(0, 1),
                            "labels": labs[:, step].flatten(0, 1)},
            adapter_rows=rows)
        leaves = tree_leaves(ad)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(
            loss.sum(), leaves)))
        upd, state = opt.update(tree_map(lambda t: grads[id(t)], ad), state,
                                stacked)
        stacked = apply_updates(stacked, upd)
        losses.append(loss.detach())
    return stacked, torch.stack(losses, dim=1)


def _vmap_round(cfg, base: dict, opt, stacked: dict, drawn: list, plan,
                cmask, *, method: str, codec, payload_of, ef, cka_probes,
                uniforms) -> tuple:
    """One vectorized round of :func:`run`: every client's local fit as one
    batch (the unsampled clients' results dropped), then the uplink (through
    ``codec`` with the stacked residual ``ef`` and client i's ``uniforms[i]``
    when a codec is on) and the server step on the stacked payload, the
    participants installing.  Returns (stacked, ef, losses of the sampled
    clients, RoundComm)."""
    m = len(drawn)
    partial = cmask is not None
    toks = torch.stack([d[0] for d in drawn])
    labs = torch.stack([d[1] for d in drawn])
    new, ls = local_fit_stacked(cfg, base, opt, stacked, toks, labs)
    stacked = (client_batch.select_clients(
        plan.mask(m, which="sampled"), new, stacked) if partial else new)
    losses = ls[:, -1].cpu().numpy()[plan.sampled].tolist()

    def keep(new_tree, old_tree):       # the participants take the new
        return (client_batch.select_clients(cmask, new_tree, old_tree)
                if partial else new_tree)

    rc = comm.RoundComm.zero()
    if codec is not None:
        payload = payload_of(stacked)
        enc, served, ef_new = compress.encode_stacked(codec, payload, ef,
                                                      uniforms)
        rc = comm.round_comm_compressed_stacked(enc, payload,
                                                plan.n_participants)
        ef = keep(ef_new, ef)
    if method == "celora":
        if codec is None:
            served = tri_lora.tree_payload(stacked)
            rc = comm.round_comm_stacked(served, plan.n_participants)
        s_model = cka.pairwise_model_similarity_stacked(served, cka_probes)
        w = aggregation.personalized_weights(s_model, participants=cmask)
        mixed = aggregation.aggregate_stacked(served, w)
        stacked = keep(tri_lora.tree_load_payload(stacked, mixed), stacked)
    elif method == "fedavg":
        if codec is None:
            served = stacked
            rc = comm.round_comm_stacked(served, plan.n_participants)
        g = aggregation.fedavg_stacked(served, [1] * m, cmask)
        stacked = keep(client_batch.broadcast_to_clients(g, m), stacked)
    return stacked, ef, losses, rc


def run(arch: str = "fed-100m", clients: int = 4, rounds: int = 10,
        local_steps: int = 20, batch: int = 8, seq: int = 256,
        lr: float = 3e-3, seed: int = 0, method: str = "celora",
        ckpt: str | None = None, verbose: bool = True,
        reduced: bool = False, client_parallelism: str = "vmap",
        participation: float = 1.0, sampler: str = "uniform",
        straggler_frac: float = 0.0, engine: str = "eager",
        chunk_rounds: int = 8, resume: bool = False,
        uplink_codec: str = "none", scan_donate: bool = True,
        scan_prefetch: bool = True, client_store: str = "device",
        buffer_size: int = 0, async_concurrency: int = 0,
        staleness_decay: float = 1.0, latency: str = "uniform",
        latency_scale: float = 1.0, latency_sigma: float = 0.5,
        attn_impl: str | None = None, *, device="cuda",
        base: Optional[dict] = None,
        init_adapters: Optional[Sequence[dict]] = None,
        cka_probes: Optional[torch.Tensor] = None,
        sr_uniforms: Optional[Callable[[int, int],
                                       compress.Uniforms]] = None) -> dict:
    """The JAX package's ``run`` with its signature (the async engine's
    knobs are read by ``engine="async"`` only, as there), on ``device``.
    With ``engine="scan"``, ``ckpt`` names the state file written at every
    chunk boundary (``resume`` continues from it), and the history rows
    carry ``host_s`` / ``device_s``; the async engine's rows carry the
    virtual arrival time ``sim_t`` and the mean ``staleness`` of the
    flush.  Returns {"history", "adapters", "cfg", "base"}."""
    _validate(clients, participation, straggler_frac, method,
              client_parallelism, engine, client_store, resume,
              (latency, latency_scale, latency_sigma))
    codec = compress.get_codec(uplink_codec)
    dev = resolve_device(device)
    partial = participation < 1.0 or straggler_frac > 0.0
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if attn_impl is not None:
        if attn_impl not in attention.IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}; "
                             f"expected one of {attention.IMPLS}")
        cfg = cfg.with_overrides(attn_impl=attn_impl)
    if base is None:
        base = model.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed))["base"]
    check_on(base, dev, "base")

    # per-client Zipf-Markov LM streams with client-specific transitions
    streams = [synthetic.make_lm_data(seed + 17 * i, 200_000,
                                      cfg.vocab_size) for i in range(clients)]
    iters = [synthetic.lm_batches(s, batch, seq, seed=seed + i)
             for i, s in enumerate(streams)]
    if init_adapters is None:
        init_adapters = []
        for i in range(clients):
            groups, tail = transformer.init_stack_adapters(
                torch.Generator(device=dev).manual_seed(seed + i), cfg)
            init_adapters.append({"groups": groups, "tail": tail})
    if len(init_adapters) != clients:
        raise ValueError(f"{len(init_adapters)} initial adapters for "
                         f"{clients} clients")
    adapters = list(init_adapters)
    for a in adapters:
        check_on(a, dev, "init_adapters")
    vectorized = client_parallelism == "vmap"
    opt = adamw(lr=lr, stacked=vectorized)
    pstore = None
    if vectorized and client_store == "sharded":
        # the client axis over the device mesh: d row blocks between rounds;
        # at d = 1 (one card) the resident stack is the block itself
        pstore = ShardedClientStore(adapters, device=dev)
    stacked = ((pstore.resident() if pstore is not None
                else client_batch.stack_states(adapters))
               if vectorized and client_store != "host" else None)

    compressed = not codec.is_identity and method in ("celora", "fedavg")
    payload_of = tri_lora.tree_payload if method == "celora" else (
        lambda t: t)
    if compressed:
        ef = (compress.init_ef(payload_of(stacked)) if stacked is not None
              else [compress.init_ef(payload_of(a)) for a in adapters])
        sr_uniforms = sr_uniforms or (
            lambda rnd, i: compress.client_generator(seed, rnd, i))
    if method == "celora":
        if cka_probes is None:
            cka_probes = cka.draw_probes(
                torch.Generator(device=dev).manual_seed(seed + 99),
                CKA_PROBES, cfg.lora_rank)
        cka_probes = torch.as_tensor(cka_probes, dtype=torch.float32,
                                     device=dev)

    def draw_np(i: int):
        bs = [next(iters[i]) for _ in range(local_steps)]
        return (np.stack([b["tokens"] for b in bs]),
                np.stack([b["labels"] for b in bs]))

    def draw(i: int):
        return tuple(torch.as_tensor(a, device=dev) for a in draw_np(i))

    # per-round participation plans, deterministic in the seed (weighted
    # sampling sees the equal per-client stream sizes)
    stream_sizes = [len(s) for s in streams]
    plans = [(sampling.build_plan(sampler, clients, participation,
                                  straggler_frac, rnd, seed,
                                  sample_counts=stream_sizes)
              if partial else sampling.full_plan(clients, rnd))
             for rnd in range(rounds)]

    def finish(history: list, adapters: list) -> dict:
        """The result; with ``ckpt`` client 0's adapter saved first (the
        scan engine's ``ckpt`` is its state file instead)."""
        if ckpt and engine != "scan":
            save(ckpt, {"adapter_client0": adapters[0]},
                 metadata={"arch": arch, "rounds": rounds, "method": method})
            if verbose:
                print(f"saved adapter checkpoint -> {ckpt}")
        return {"history": history, "adapters": adapters, "cfg": cfg,
                "base": base}

    common = dict(cfg=cfg, base=base, opt=opt, draw_np=draw_np, plans=plans,
                  method=method, clients=clients, codec=codec,
                  compressed=compressed, payload_of=payload_of,
                  cka_probes=cka_probes, sr_uniforms=sr_uniforms, device=dev,
                  verbose=verbose)
    if client_store == "host":
        return finish(*_run_host_lm(adapters=adapters, **common))
    if engine == "async":
        return finish(*_run_async_lm(
            stacked=stacked, rounds=rounds, seed=seed,
            buffer_size=buffer_size, concurrency=async_concurrency,
            staleness_decay=staleness_decay,
            latency_model=sampling.LatencyModel(latency, latency_scale,
                                                latency_sigma), **common))
    if engine == "scan":
        return finish(*_run_scan_lm(
            stacked=stacked, rounds=rounds, chunk_rounds=chunk_rounds,
            seed=seed, ckpt=ckpt, resume=resume, donate=scan_donate,
            prefetch=scan_prefetch, client_store=client_store, **common))

    history = []
    for rnd in range(rounds):
        t0 = time.perf_counter()
        plan = plans[rnd]
        smask = plan.mask(clients, which="sampled")
        cmask = (torch.as_tensor(plan.mask(clients), device=dev) if partial
                 else None)
        if vectorized:
            drawn = [draw(i) for i in range(clients)]   # all: stream parity
            stacked, ef, losses, rc = _vmap_round(
                cfg, base, opt, stacked, drawn, plan, cmask, method=method,
                codec=codec if compressed else None, payload_of=payload_of,
                ef=ef if compressed else None, cka_probes=cka_probes,
                uniforms=([sr_uniforms(rnd, i) for i in range(clients)]
                          if compressed else None))
            if pstore is not None:
                pstore.adopt(stacked)
                stacked = pstore.resident()
        else:
            losses = []
            for i in range(clients):
                toks, labs = draw(i)          # ALWAYS draw: stream alignment
                if not smask[i]:
                    continue                  # unsampled: frozen this round
                adapters[i], ls = local_fit(cfg, base, opt, adapters[i],
                                            toks, labs)
                losses.append(float(ls[-1]))

            rc = comm.RoundComm.zero()
            if compressed:
                # bytes priced on the ENCODED trees, the server consumes
                # the dequantized payloads, EF advances for delivered
                # uploads only
                payloads = [payload_of(a) for a in adapters]
                encoded = [compress.encode_client(codec, payloads[i], ef[i],
                                                  sr_uniforms(rnd, i))
                           for i in range(clients)]
                rc = comm.round_comm_compressed_payloads(
                    [encoded[i][0] for i in plan.participants],
                    [payloads[i] for i in plan.participants])
                served = [e[1] for e in encoded]
                for i in plan.participants:
                    ef[i] = encoded[i][2]
            if method == "celora":
                if not compressed:
                    served = [tri_lora.tree_payload(a) for a in adapters]
                    rc = comm.round_comm_payloads(
                        [served[i] for i in plan.participants])
                s_model = cka.pairwise_model_similarity(served, cka_probes)
                w = aggregation.personalized_weights(s_model,
                                                     participants=cmask)
                downs = aggregation.aggregate_payloads(served, w)
                for i in plan.participants:
                    adapters[i] = tri_lora.tree_load_payload(adapters[i],
                                                             downs[i])
            elif method == "fedavg":
                if not compressed:
                    served = adapters
                    rc = comm.round_comm_payloads(
                        [served[i] for i in plan.participants])
                g = aggregation.fedavg(served, [1] * clients, cmask)
                for i in plan.participants:
                    adapters[i] = g

        history.append(_lm_record(rnd, losses, rc,
                                  plan.participants.tolist(), t0, verbose,
                                  clients))

    if vectorized:
        adapters = client_batch.unstack_states(stacked)
    return finish(history, adapters)


def _lm_record(rnd: int, losses, rc: comm.RoundComm, participants: list,
               t0: float, verbose: bool, clients: int) -> dict:
    """One eager round's history row (and its printed line)."""
    rec = {"round": rnd, "loss": float(np.mean(losses)),
           "uplink_floats": rc.uplink_elems,
           "uplink_bytes": rc.uplink_bytes,
           "downlink_bytes": rc.downlink_bytes,
           "participants": participants,
           "wall_s": time.perf_counter() - t0}
    if verbose:
        print(f"round {rnd:3d}  loss {rec['loss']:.4f}  "
              f"uplink {rc.uplink_bytes}B "
              f"({len(participants)}/{clients} clients)  "
              f"{rec['wall_s']:.1f}s", flush=True)
    return rec


def _run_host_lm(*, cfg, base: dict, opt, adapters: list, draw_np, plans,
                 method: str, clients: int, codec, compressed: bool,
                 payload_of, cka_probes, sr_uniforms, device,
                 verbose: bool) -> tuple[list, list]:
    """Host-backed LM rounds (``client_store="host"``, the JAX package's
    ``_run_host_lm``): the m adapters live in a
    :class:`repro_torch.core.client_store.HostClientStore`; each round
    gathers the sampled cohort to the device, fits it as one batch,
    aggregates over the cohort and writes it back.  For CE-LoRA a device
    bank of every client's C payload (plus its EF residual when
    compressed) backs the all-m CKA; the adapters never stack on the
    device.  Returns (history, adapters), the adapters on the host."""
    dev = torch.device(device)
    store = client_store.HostClientStore(adapters, device=dev)
    bank = ef_bank = ef_store = None
    if method == "celora":
        bank = tree_map(lambda t: t.to(dev, copy=True),
                        payload_of(store.population))
        if compressed:
            ef_bank = compress.init_ef(bank)
    elif method == "fedavg" and compressed:
        # FedAvg's EF residuals live on the host beside the adapters
        ef_store = client_store.HostClientStore(
            [compress.init_ef(payload_of(a)) for a in adapters], device=dev)

    history = []
    for rnd, plan in enumerate(plans):
        t0 = time.perf_counter()
        drawn = [draw_np(i) for i in range(clients)]   # all: stream parity
        cids = plan.sampled
        toks, labs = client_batch.to_device(
            tuple(client_batch.host_tensor(
                np.stack([drawn[i][j] for i in cids]), dev) for j in (0, 1)),
            dev)
        cohort, ls = local_fit_stacked(cfg, base, opt, store.gather(cids),
                                       toks, labs)
        losses = ls[:, -1].cpu().numpy().tolist()
        pml, pmf, cdev = client_batch.to_device(
            (client_batch.host_tensor(plan.cohort_mask(), dev),
             client_batch.host_tensor(plan.mask(clients), dev),
             client_batch.host_tensor(cids.astype(np.int64), dev)), dev)
        payload = payload_of(cohort)
        rc = comm.RoundComm.zero()
        if method == "celora":
            # the fresh cohort Cs join the all-m bank before the encode and
            # the CKA; the bank is re-scattered after the install, so that
            # its rows stay each client's current C
            bank = client_batch.scatter_clients(bank, cdev, payload)
            if compressed:
                enc, served_all, ef_all = compress.encode_stacked(
                    codec, bank, ef_bank,
                    [sr_uniforms(rnd, i) for i in range(clients)])
                ef_bank = client_batch.select_clients(pmf, ef_all, ef_bank)
                rc = comm.round_comm_compressed_stacked(
                    enc, bank, plan.n_participants)
            else:
                served_all = bank
                rc = comm.round_comm_stacked(bank, plan.n_participants)
            s_model = cka.pairwise_model_similarity_stacked(served_all,
                                                            cka_probes)
            w = aggregation.personalized_weights(s_model, participants=pmf)
            # participants ⊆ cohort: every nonzero column is a cohort row
            mixed = aggregation.aggregate_stacked(
                client_batch.gather_clients(served_all, cdev),
                w[cdev[:, None], cdev[None, :]])
            cohort = client_batch.select_clients(
                pml, tri_lora.tree_load_payload(cohort, mixed), cohort)
            bank = client_batch.scatter_clients(bank, cdev,
                                                payload_of(cohort))
        elif method == "fedavg":
            if compressed:
                ef_c = ef_store.gather(cids)
                enc, served, ef_new = compress.encode_stacked(
                    codec, payload, ef_c,
                    [sr_uniforms(rnd, int(i)) for i in cids])
                rc = comm.round_comm_compressed_stacked(
                    enc, payload, plan.n_participants)
                ef_store.scatter(cids, client_batch.select_clients(
                    pml, ef_new, ef_c))
            else:
                served = payload
                rc = comm.round_comm_stacked(payload, plan.n_participants)
            g = aggregation.fedavg_stacked(served, [1] * len(cids), pml)
            cohort = client_batch.select_clients(
                pml, client_batch.broadcast_to_clients(g, len(cids)), cohort)
        store.scatter(cids, cohort)
        history.append(_lm_record(rnd, losses, rc,
                                  plan.participants.tolist(), t0, verbose,
                                  clients))
    return history, store.unstack()


def _run_async_lm(*, cfg, base: dict, opt, stacked: dict, draw_np, plans,
                  method: str, clients: int, rounds: int, seed: int,
                  codec, compressed: bool, payload_of, buffer_size: int,
                  concurrency: int, staleness_decay: float,
                  latency_model: sampling.LatencyModel, cka_probes,
                  sr_uniforms, device, verbose: bool) -> tuple[list, list]:
    """Asynchronous buffered LM rounds (``engine="async"``, the JAX
    package's ``_run_async_lm``): the
    :class:`repro_torch.core.async_engine.AsyncScheduler` replays the
    seeded virtual-time arrivals; each dispatched group fits as one batch
    (its uplink encoded with each record's (wave, client) uniforms), the
    uploads wait in the server's buffer, and every ``buffer_size``
    arrivals the aggregate is rebuilt with the ``staleness_decay**s``
    column discount.  At the zero-staleness limit this is the eager
    driver's history.  Returns (history, adapters)."""
    from repro_torch.core.async_engine import AsyncScheduler

    dev = torch.device(device)
    k = int(plans[0].sampled.size)
    K = int(buffer_size) if buffer_size else k
    if not 1 <= K <= k:
        raise ValueError(f"buffer_size must be in [1, cohort size {k}]; "
                         f"got {K}")
    Mc = int(concurrency) if concurrency else k
    decay = float(staleness_decay)
    if not 0.0 < decay <= 1.0:
        raise ValueError(f"staleness_decay must be in (0, 1]; got {decay}")
    has_payload = method in ("celora", "fedavg")
    per_b, per_e, per_down_b = compress.per_client_traffic(
        codec, payload_of(meta_like(stacked)) if has_payload else None,
        clients, compressed)
    state = {"stacked": stacked,
             "ef": compress.init_ef(payload_of(stacked))
             if compressed else None}

    def fit(stk, ef, ids, records, toks, labs):
        rows = client_batch.gather_clients(stk, ids)
        new, ls = local_fit_stacked(cfg, base, opt, rows, toks, labs)
        if compressed:
            _, served, ef_new = compress.encode_stacked(
                codec, payload_of(new), client_batch.gather_clients(ef, ids),
                [sr_uniforms(r.wave, r.client) for r in records])
            ef = client_batch.scatter_clients(ef, ids, ef_new)
        else:
            served = payload_of(new) if has_payload else None
        return client_batch.scatter_clients(stk, ids, new), ef, ls, served

    def flush(stk, served_k, ids, stale):
        pmask = client_batch.id_mask(clients, ids)
        col = None
        if decay != 1.0:
            col = torch.ones(clients, dtype=torch.float32,
                             device=dev).index_copy(
                0, ids, torch.pow(decay, stale.to(torch.float32)))
        served_m = client_batch.scatter_clients(payload_of(stk), ids,
                                                served_k)
        if method == "celora":
            s_model = cka.pairwise_model_similarity_stacked(served_m,
                                                            cka_probes)
            w = aggregation.personalized_weights(s_model, participants=pmask,
                                                 col_scale=col)
            mixed = aggregation.aggregate_stacked(served_m, w)
            return client_batch.select_clients(
                pmask, tri_lora.tree_load_payload(stk, mixed), stk)
        g = aggregation.fedavg_stacked(served_m, [1] * clients, pmask,
                                       col_scale=col)
        return client_batch.select_clients(
            pmask, client_batch.broadcast_to_clients(g, clients), stk)

    consumed = np.zeros(clients, np.int64)
    history: list = []
    t_last = [time.perf_counter()]

    def fit_group(records):
        toks, labs = [], []
        for r in records:
            # draw and discard over the waves the client was not
            # dispatched for: one session per wave, the eager driver's
            # stream positions
            while consumed[r.client] < r.wave:
                draw_np(r.client)
                consumed[r.client] += 1
            tk, lb = draw_np(r.client)
            consumed[r.client] += 1
            toks.append(tk)
            labs.append(lb)
        ids = torch.tensor([r.client for r in records], device=dev)
        tk, lb = client_batch.to_device(
            (client_batch.host_tensor(np.stack(toks), dev),
             client_batch.host_tensor(np.stack(labs), dev)), dev)
        state["stacked"], state["ef"], ls, served = fit(
            state["stacked"], state["ef"], ids, records, tk, lb)
        ls = ls[:, -1].cpu().numpy()
        for j, r in enumerate(records):
            r.loss = float(ls[j])
            if served is not None:
                r.upload = tree_map(lambda l, j=j: l[j], served)

    def on_flush(records, f, sim_now):
        stale = np.asarray([f - r.version for r in records], np.float64)
        if has_payload:
            state["stacked"] = flush(
                state["stacked"],
                tree_map(lambda *xs: torch.stack(xs),
                         *[r.upload for r in records]),
                torch.tensor([r.client for r in records], device=dev),
                torch.as_tensor(stale, device=dev))
        now = time.perf_counter()
        rec = {"round": f,
               "loss": float(np.mean([r.loss for r in records])),
               "uplink_floats": per_e * K, "uplink_bytes": per_b * K,
               "downlink_bytes": per_down_b * K,
               "participants": sorted(r.client for r in records),
               "wall_s": now - t_last[0], "sim_t": float(sim_now),
               "staleness": float(np.mean(stale))}
        t_last[0] = now
        history.append(rec)
        if verbose:
            print(f"flush {f:3d}  t={sim_now:8.2f}  loss {rec['loss']:.4f}"
                  f"  uplink {rec['uplink_bytes']}B  stale "
                  f"{rec['staleness']:.2f}", flush=True)

    AsyncScheduler(waves=[np.asarray(p.sampled) for p in plans], m=clients,
                   latency=latency_model, seed=seed, buffer_size=K,
                   concurrency=Mc, rounds=rounds, fit_group=fit_group,
                   flush_cb=on_flush).run()
    return history, client_batch.unstack_states(state["stacked"])


def _run_scan_lm(*, cfg, base: dict, opt, stacked: dict, draw_np, plans,
                 method: str, clients: int, rounds: int, chunk_rounds: int,
                 seed: int, ckpt: Optional[str], resume: bool,
                 verbose: bool, codec, compressed: bool, payload_of,
                 donate: bool, prefetch: bool, client_store: str,
                 cka_probes, sr_uniforms, device) -> tuple[list, list]:
    """The LM rounds in chunks (the JAX package's ``_run_scan_lm``): every
    client's local fit as one batch, the select, the uplink with the
    residual ``ef`` in the carry, the server step, the masked install —
    no read-back inside a chunk; the chunk's losses come back in one sync.
    Each chunk is one cached program (on a card one CUDA graph a chunk
    length, the JAX package's ``run_chunk``), the carry donated with
    ``donate``; the programs are the run's own (they read its probes and
    its optimizer) and go with it.  With
    ``ckpt`` the stacked adapters, ``ef`` and the history are saved at
    every chunk boundary; ``resume`` restores them, draws past the
    completed rounds and continues.  Returns (history, adapters)."""
    dev = torch.device(device)
    chunk = max(1, int(chunk_rounds))
    pstack = sampling.stack_plans(plans, clients)
    meta = meta_like(stacked)
    payload_struct = (tri_lora.tree_payload(meta) if method == "celora"
                      else meta if method == "fedavg" else None)
    per_b, per_e, per_down_b = compress.per_client_traffic(
        codec, payload_struct, clients, compressed)
    ef = compress.init_ef(payload_of(stacked)) if compressed else {}
    ones = torch.ones((clients,), dtype=torch.float32, device=dev)
    fingerprint = {"arch": cfg.name, "method": method, "clients": clients,
                   "seed": seed, "uplink_codec": codec.name,
                   "client_store": client_store, "attn_impl": cfg.attn_impl}

    hist_loss: list = []
    hist_wall: list = []
    hist_host: list = []
    hist_dev: list = []
    start = 0
    if resume and ckpt and not os.path.exists(ckpt):
        warnings.warn(f"resume: no checkpoint at {ckpt!r} — starting from "
                      f"round 0 (checkpoints will be written there)")
    if resume and ckpt and os.path.exists(ckpt):
        meta_ck = metadata(ckpt)
        if "rounds_done" not in meta_ck:
            raise ValueError(f"{ckpt!r} is not a scan-engine checkpoint "
                             f"(no rounds_done in metadata)")
        check_fingerprint(ckpt, meta_ck, fingerprint,
                          defaults={"uplink_codec": "none",
                                    "client_store": "device",
                                    "attn_impl": "auto"})
        start = int(meta_ck["rounds_done"])
        if start > rounds:
            raise ValueError(f"checkpoint has {start} completed rounds but "
                             f"the run asks for only {rounds}")
        tree = restore(ckpt, {"state": stacked, "ef": ef,
                              "loss": np.zeros(start, np.float32),
                              "wall": np.zeros(start, np.float32)})
        stacked, ef = tree["state"], tree["ef"]
        hist_loss = [float(v) for v in tree["loss"]]
        hist_wall = [float(v) for v in tree["wall"]]
        hist_host = [0.0] * start
        hist_dev = [0.0] * start
        for _ in range(start):          # fast-forward the data streams
            for i in range(clients):
                draw_np(i)
        if verbose:
            print(f"resumed {start} rounds from {ckpt}", flush=True)

    def round_step(carry, toks, labs, smask, pmask, u):
        stk, ef = carry
        new, ls = local_fit_stacked(cfg, base, opt, stk, toks, labs)
        stk = client_batch.select_clients(smask, new, stk)
        if compressed:
            _, served, ef_new = compress.encode_stacked(
                codec, payload_of(stk), ef, uniforms=u)
            ef = client_batch.select_clients(pmask, ef_new, ef)
        else:
            served = payload_of(stk)
        if method == "celora":
            s_model = cka.pairwise_model_similarity_stacked(served,
                                                            cka_probes)
            w = aggregation.personalized_weights(s_model, participants=pmask)
            mixed = aggregation.aggregate_stacked(served, w)
            stk = client_batch.select_clients(
                pmask, tri_lora.tree_load_payload(stk, mixed), stk)
        elif method == "fedavg":
            g = aggregation.fedavg_stacked(served, ones, pmask)
            stk = client_batch.select_clients(
                pmask, client_batch.broadcast_to_clients(g, clients), stk)
        sm = smask.to(ls.dtype)
        loss = torch.sum(ls[:, -1] * sm) / torch.clamp_min(torch.sum(sm),
                                                           1.0)
        return (stk, ef), loss

    def chunk_fn(carry, toks, labs, smask, pmask, u):
        """The chunk program (a run's own: it reads the run's probes):
        ``round_step`` for each of the chunk's rounds → (carry, (rounds,)
        losses)."""
        losses = []
        for j in range(toks.shape[0]):
            carry, loss = round_step(carry, toks[j], labs[j], smask[j],
                                     pmask[j], [l[j] for l in u] if u
                                     else None)
            losses.append(loss)
        return carry, torch.stack(losses)

    chunk_programs = jit_cache.JitCache(maxsize=2)   # a chunk and the tail
    run_chunk = jit_cache.jit(chunk_programs, (), "scan", chunk_fn,
                              donate_argnums=(0,) if donate else ())
    next_round = [start]

    def produce(n_rounds: int):
        """A chunk's batches (n_rounds, m, steps, B, S), drawn round-major
        then client-minor, and the codec's uniforms per payload leaf."""
        r0 = next_round[0]
        next_round[0] += n_rounds
        drawn = [[draw_np(i) for i in range(clients)]
                 for _ in range(n_rounds)]
        toks, labs = (client_batch.host_tensor(np.stack(
            [np.stack([d[k] for d in rr]) for rr in drawn]), dev)
            for k in (0, 1))
        u = None
        if compressed and codec.qmax is not None:
            per_round = [compress.stacked_uniforms(
                codec, payload_struct,
                [sr_uniforms(r, i) for i in range(clients)])
                for r in range(r0, r0 + n_rounds)]
            u = [client_batch.host_tensor(torch.stack(leaf), dev)
                 for leaf in zip(*per_round)]
        return toks, labs, u

    def dispatch(carry, batches, c0, c1):
        toks, labs, u = client_batch.to_device(batches, dev)
        smask, pmask = client_batch.to_device(
            [client_batch.host_tensor(a[c0:c1], dev)
             for a in (pstack.sampled_mask, pstack.participant_mask)], dev)
        carry, losses = run_chunk(carry, toks, labs, smask, pmask, u)
        return carry, losses.cpu().numpy()  # the one sync

    def on_chunk(carry, c0, c1, losses, host_s, device_s, wall_s):
        hist_loss.extend(float(v) for v in losses)
        hist_wall.extend([wall_s] * (c1 - c0))
        hist_host.extend([host_s] * (c1 - c0))
        hist_dev.extend([device_s] * (c1 - c0))
        if ckpt:
            save(ckpt, {"state": carry[0], "ef": carry[1],
                        "loss": np.asarray(hist_loss, np.float32),
                        "wall": np.asarray(hist_wall, np.float32)},
                 metadata={"rounds_done": c1, "engine": "scan",
                           **fingerprint})
        if verbose:
            print(f"rounds {c0:3d}–{c1 - 1:3d}  loss "
                  f"{hist_loss[-1]:.4f}  ({wall_s:.1f}s/round)", flush=True)

    carry = client_batch.drive_chunks(
        (stacked, ef), chunk_schedule(start, rounds, chunk), produce,
        dispatch, on_chunk, donate=donate, prefetch=prefetch)

    history = [{"round": rnd, "loss": hist_loss[rnd],
                "uplink_floats": per_e * plans[rnd].n_participants,
                "uplink_bytes": per_b * plans[rnd].n_participants,
                "downlink_bytes": per_down_b * plans[rnd].n_participants,
                "participants": plans[rnd].participants.tolist(),
                "wall_s": hist_wall[rnd],
                "host_s": hist_host[rnd], "device_s": hist_dev[rnd]}
               for rnd in range(rounds)]
    chunk_programs.clear()                 # the run's graphs go with it
    return history, client_batch.unstack_states(carry[0])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="fed-100m")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--method", default="celora", choices=list(METHODS))
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny variant (2 layers, width 256)")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients sampled per round (0, 1]")
    ap.add_argument("--sampler", default="uniform",
                    choices=list(sampling.SAMPLERS))
    ap.add_argument("--straggler-frac", type=float, default=0.0,
                    help="fraction of sampled clients dropped after local fit")
    ap.add_argument("--uplink-codec", default="none",
                    choices=list(compress.CODECS),
                    help="quantized uplink compression with error feedback")
    ap.add_argument("--attn-impl", default=None, choices=attention.IMPLS,
                    help="attention backend; default: the arch config's")
    ap.add_argument("--client-parallelism", default="vmap",
                    choices=["loop", "vmap"],
                    help="clients one after another, or all as one batch")
    ap.add_argument("--engine", default="eager",
                    choices=["eager", "scan", "async"],
                    help="scan: rounds in chunks, one host sync a chunk, "
                         "checkpoint and resume; async: the buffered, "
                         "staleness-weighted server on a virtual clock")
    ap.add_argument("--chunk-rounds", type=int, default=8,
                    help="scan engine: rounds per chunk")
    ap.add_argument("--resume", action="store_true",
                    help="scan engine: restore --ckpt and continue")
    ap.add_argument("--no-donate", action="store_true",
                    help="scan engine: keep each chunk's old carry")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="scan engine: draw each chunk inline")
    ap.add_argument("--buffer-size", type=int, default=0,
                    help="async engine: aggregate every K arrivals "
                         "(0 = cohort size, the zero-staleness limit)")
    ap.add_argument("--async-concurrency", type=int, default=0,
                    help="async engine: most clients in flight "
                         "(0 = cohort size)")
    ap.add_argument("--staleness-decay", type=float, default=1.0,
                    help="async engine: contribution discount "
                         "decay**staleness (1.0 = none)")
    ap.add_argument("--latency", default="uniform",
                    choices=list(sampling.LATENCIES),
                    help="async engine: virtual client latency model")
    ap.add_argument("--latency-scale", type=float, default=1.0)
    ap.add_argument("--latency-sigma", type=float, default=0.5,
                    help="async engine: lognormal latency sigma")
    ap.add_argument("--client-store", default="device",
                    choices=list(client_store.STORE_BACKENDS),
                    help="population residency: the device-resident stack, "
                         "the stack in row blocks over the client mesh "
                         "(sharded), or host-resident with a per-round "
                         "cohort gather and write-back")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(arch=args.arch, clients=args.clients, rounds=args.rounds,
              local_steps=args.local_steps, batch=args.batch, seq=args.seq,
              lr=args.lr, seed=args.seed, method=args.method,
              ckpt=args.ckpt, reduced=args.reduced,
              participation=args.participation, sampler=args.sampler,
              straggler_frac=args.straggler_frac,
              uplink_codec=args.uplink_codec, attn_impl=args.attn_impl,
              client_parallelism=args.client_parallelism,
              engine=args.engine, chunk_rounds=args.chunk_rounds,
              resume=args.resume, scan_donate=not args.no_donate,
              scan_prefetch=not args.no_prefetch,
              client_store=args.client_store, buffer_size=args.buffer_size,
              async_concurrency=args.async_concurrency,
              staleness_decay=args.staleness_decay, latency=args.latency,
              latency_scale=args.latency_scale,
              latency_sigma=args.latency_sigma, device=args.device)
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} over {args.rounds} rounds")
    return out


if __name__ == "__main__":
    main()
