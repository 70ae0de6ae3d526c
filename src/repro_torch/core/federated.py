"""Federated fine-tuning runtime (paper Algorithm 1): PyTorch port of
``repro.core.federated``, the eager engine's ``loop`` and ``vmap`` paths.

One server, m clients.  Per round: each sampled client locally fine-tunes
its tri-LoRA (strategy-dependent factors) on private data (Alg. 1 line 3);
the participants uplink their payload (C for CE-LoRA — §III-B/D; A/B or B
for the baselines); the server aggregates — personalized, eqn (3), for
CE-LoRA, FedAvg otherwise — and downlinks; participants install (lines
7–9).  The one-shot dataset similarity S^data (eqns 5–6) is computed before
round 0 and the model similarity S^model (eqns 7–9, CKA over the
transmitted C) each round; their sum (eqn 4) drives the personalized
weights.  Communication is accounted exactly in bytes from the real
payload trees (:mod:`.comm`).

Client parallelism (``FedConfig.client_parallelism``):

* ``"loop"`` — the reference path: clients train one after another, every
  kernel launched once per client per step.
* ``"vmap"`` (default, as in the JAX package) — all m clients train as
  ONE batch: the states are stacked into one tree whose leaves carry a
  leading client axis (:mod:`.client_batch`, held by the device store,
  :mod:`.client_store`), the m minibatches fold into one batch of m·B
  sequences, each applying its own client's adapter (the grouped tri-LoRA
  kernels on the card), so each projection launches once per step for all
  clients; one AdamW update covers every client's leaves, the loss
  differentiated is the SUM of the m per-client means (each client gets
  exactly its own gradient), and one eval call covers the (m, pad, T) test
  stack.  All m train every round and :func:`.client_batch.select_clients`
  keeps the unsampled clients' state frozen.  Aggregation, comm and the
  codecs run on the stacked payload.  Both paths consume the same
  per-client data streams, so they agree up to floating-point order.
* ``"shard"`` — the vmap path with the population laid over the 1-D
  ``("clients",)`` device mesh (:func:`repro_torch.launch.mesh.
  make_client_mesh`, the device store's ``shard`` placement); the round
  computes on the run's device, so at d = 1 (one card) it is the vmap path
  exactly.

Fault injection and admission control (:mod:`.faults`,
:mod:`.admission`) run on both paths.  Per round the seeded fault draw
decides which clients crash or diverge (their state rolls back to the
round start), which uploads are lost or corrupted in transit (a bit flip
on the encoded wire tree under a codec), and a divergent upload is scaled
by ``fault_divergent_scale``; the norm gate admits the delivered rows,
error feedback advances and the server installs for accepted uploads only,
S^model is refreshed row-masked from the initial Cs, and the rejected rows
are zeroed before aggregation.  Bytes are priced per sent upload.  Every
such op is gated on ``robust`` (a nonzero rate or ``admission="norm"``),
so the fault-free config runs the fault-free code unchanged.

The scan engine (``engine="scan"``, :mod:`.fed_engine`) runs the same
round on the stacked clients in chunks of rounds, with one host sync per
chunk, a checkpoint at every chunk boundary and ``resume``;
``run_federated`` hands it the shared setup below.

``client_store="host"`` (:mod:`.client_store`) keeps the population in
host memory and brings only each round's cohort to the device, on both
engines, and ``"sharded"`` lays it over the client mesh in row blocks;
``engine="async"`` (:mod:`.async_engine`) replaces the round barrier by a
buffered, staleness-weighted server on a seeded virtual clock.

Uplink codecs (:mod:`.compress`): each communicating client carries an
error-feedback residual ``ef`` in its state; the round encodes every
client's uplink, prices the participants' ENCODED trees, aggregates the
dequantized payloads (S^model included) and advances the residual of the
participants only.

The random draws the JAX package takes from ``jax.random`` — client init,
the CKA probe batch, the GMM initial means and the codec's stochastic
rounding — come from generators seeded from ``fed.seed``, or ready-made
from the caller (``init_clients``, ``cka_probes``, ``gmm_init``,
``sr_uniforms``), so that a test can hand the port the JAX package's
draws.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (admission, aggregation, client_batch,
                              client_store, comm, compress, faults,
                              jit_cache, sampling, tri_lora)
from repro_torch.core.baselines import Strategy, get_strategy
from repro_torch.core.fed_model import FedTask
from repro_torch.core.similarity import cka, gmm, ot
from repro_torch.data.pipeline import Loader
from repro_torch.device import check_on, resolve_device
from repro_torch.models import attention
from repro_torch.optim import adamw, apply_updates
from repro_torch.tree import tree_leaves, tree_map

# Program caches keyed on the task's parameter OBJECTS (strong references
# + identity re-check, see repro_torch.core.jit_cache) — a bare id() key
# could silently serve a stale program for a different task after GC hands
# the id to a new object, and a plain dict grows without bound.  On a card
# each entry is a captured CUDA graph holding its static buffers and memory
# pool, so the bound is smaller than the JAX package's 16.
_LOCAL_FIT_CACHE = jit_cache.JitCache(maxsize=8)
_EVAL_CACHE = jit_cache.JitCache(maxsize=8)

PARALLELISM_MODES = ("loop", "vmap", "shard")
ENGINES = ("eager", "scan", "async")

@dataclasses.dataclass
class FedConfig:
    """Every field of the JAX package's ``FedConfig``, with its default."""
    method: str = "celora"
    n_clients: int = 10
    rounds: int = 30
    local_steps: int = 10
    batch_size: int = 16
    lr: float = 5e-3
    seed: int = 0
    # --- client dispatch: "loop" (reference) | "vmap" | "shard" ------------
    client_parallelism: str = "vmap"
    # --- population residency ---------------------------------------------
    client_store: str = "device"      # "device" | "sharded" | "host"
    # --- round dispatch -----------------------------------------------------
    engine: str = "eager"             # "eager" | "scan" | "async"
    chunk_rounds: int = 8             # scan: rounds fused per dispatch
    checkpoint_path: Optional[str] = None  # scan: state file, chunk cadence
    resume: bool = False              # scan: restore checkpoint_path first
    scan_donate: bool = True          # scan: donate the carry buffers
    scan_prefetch: bool = True        # scan: overlapped chunk prefetch
    eval_every: int = 1               # eval cadence: every k-th round + last;
    #                                   off-cadence rounds report the LAST
    #                                   evaluated accuracies
    # --- asynchronous buffered runtime --------------------------------------
    buffer_size: int = 0
    async_concurrency: int = 0
    staleness_decay: float = 1.0
    latency: str = "uniform"
    latency_scale: float = 1.0
    latency_sigma: float = 0.5
    # --- uplink compression ------------------------------------------------
    uplink_codec: str = "none"        # "none" | "bf16" | "int8" | "int4"
    # --- attention backend (models.attention.select_impl) -------------------
    attn_impl: Optional[str] = None   # None -> inherit task.cfg.attn_impl
    # --- partial participation (core.sampling) -----------------------------
    participation: float = 1.0        # fraction of clients sampled per round
    sampler: str = "uniform"          # "uniform" | "weighted" | "round_robin"
    straggler_frac: float = 0.0       # sampled clients dropped after local fit
    # --- CE-LoRA similarity knobs (§III-C) ---------------------------------
    gmm_components: int = 2
    gmm_iters: int = 15
    feature_samples: int = 128        # per-client GMM feature budget
    sinkhorn_eps: float = 0.05
    use_data_sim: bool = True
    use_model_sim: bool = True
    cka_probes: int = 64
    self_weight: float = 0.0          # beyond-paper λ self-mixing (0=paper)
    # --- pFedMe -------------------------------------------------------------
    pfedme_eta: float = 0.5
    # --- fault injection ----------------------------------------------------
    fault_crash: float = 0.0
    fault_loss: float = 0.0
    fault_corrupt: float = 0.0
    fault_corrupt_mode: str = "nan"   # "nan" | "inf" | "bitflip"
    fault_divergent: float = 0.0
    fault_divergent_scale: float = 1e4
    # --- server-side uplink admission ---------------------------------------
    admission: str = "none"           # "none" | "norm"
    admission_norm_mult: float = 10.0
    admission_window: int = 8
    # --- async retry/timeout/backoff ----------------------------------------
    dispatch_timeout: float = 0.0
    retry_backoff: float = 1.0
    retry_cap: int = 3


@dataclasses.dataclass
class RoundRecord:
    round: int
    train_loss: float     # mean local loss over the SAMPLED clients
    accs: list            # per-client test accuracy (all m, every round)
    uplink_bytes: int     # exact payload bytes up this round (participants)
    downlink_bytes: int   # exact payload bytes down this round
    wall_s: float
    participants: list = dataclasses.field(default_factory=list)
    sampled: list = dataclasses.field(default_factory=list)
    dropped: list = dataclasses.field(default_factory=list)
    uplink_elems: int = 0  # dtype-blind element count
    host_s: float = 0.0    # time drawing the batches on the host (0.0:
    #                        not measured, the eager loop path)
    device_s: float = 0.0  # the rest of the round: device work, read-backs
    evaluated: bool = True  # False: accs carried from the last eval round
    rejected: list = dataclasses.field(default_factory=list)
    failed: list = dataclasses.field(default_factory=list)

    @property
    def mean_acc(self):
        return float(np.mean(self.accs))

    @property
    def min_acc(self):
        return float(np.min(self.accs))

    @property
    def max_acc(self):
        return float(np.max(self.accs))


# ---------------------------------------------------------------------------
# S^data — one-shot GMM + OT dataset similarity (paper §III-C.1)
# ---------------------------------------------------------------------------

GmmInit = Callable[[int, int, int], Any]   # (client, category, n) -> (G,) idx


def default_gmm_init(fed: FedConfig, device) -> GmmInit:
    """Initial-mean indices of client ``ci``'s category ``k`` drawn from a
    generator seeded ``fed.seed + 31·ci + k`` (the JAX package keys its
    draw the same way)."""
    def draw(ci: int, k: int, n: int):
        g = torch.Generator(device=device).manual_seed(fed.seed + 31 * ci + k)
        return gmm.draw_init_idx(g, n, fed.gmm_components)
    return draw


@torch.no_grad()
def data_similarity(task: FedTask, fed: FedConfig, client_train: list,
                    *, gmm_init: Optional[GmmInit] = None) -> torch.Tensor:
    """One-shot S^data (m, m) on the task's device: per-(client, category)
    GMMs on frozen-backbone features (§III-C.1), all pairwise OT dataset
    distances (eqns 5–6) in one batched solve, and distance → affinity.
    The feature subsample and the padding of sparse categories follow the
    JAX package's numpy stream exactly."""
    dev = tree_leaves(task.base)[0].device
    gmm_init = gmm_init or default_gmm_init(fed, dev)
    g = fed.gmm_components
    m, k_cls = len(client_train), task.n_classes
    fits, counts = [], []
    rng = np.random.default_rng(fed.seed + 11)
    for ci, data in enumerate(client_train):
        toks, labs = data["tokens"], data["labels"]
        take = rng.permutation(len(labs))[:fed.feature_samples]
        f = task.features(torch.as_tensor(toks[take], device=dev))
        lab = labs[take]
        per_k = []
        for k in range(k_cls):
            fk = f[torch.as_tensor(np.nonzero(lab == k)[0], device=dev)]
            if fk.shape[0] < max(2 * g, 4):           # pad sparse categories
                pad = f[torch.as_tensor(
                    rng.integers(0, f.shape[0], max(2 * g, 4)), device=dev)]
                fk = torch.cat([fk, pad]) if fk.numel() else pad
            idx = torch.as_tensor(gmm_init(ci, k, int(fk.shape[0])),
                                  device=dev)
            per_k.append(gmm.fit_gmm(idx, fk, g, fed.gmm_iters))
        fits.append(gmm.GMM(*(torch.stack(t) for t in zip(*per_k))))
        counts.append([float((labs == k).sum()) for k in range(k_cls)])
    bank = gmm.GMM(*(torch.stack(t) for t in zip(*fits)))   # (m, K, G, …)
    cnt = torch.tensor(counts, dtype=torch.float32, device=dev)
    iu, ju = (torch.as_tensor(a, device=dev) for a in np.triu_indices(m, 1))
    vals = ot.dataset_distance(gmm.GMM(*(t[iu] for t in bank)), cnt[iu],
                               gmm.GMM(*(t[ju] for t in bank)), cnt[ju],
                               fed.sinkhorn_eps)
    dist = torch.zeros((m, m), dtype=vals.dtype, device=dev)
    dist[iu, ju] = vals
    return ot.distance_to_affinity(dist + dist.T)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _validate(fed: FedConfig, strategy: Strategy, n_train: int) -> None:
    mode = fed.client_parallelism
    if mode not in PARALLELISM_MODES:
        raise ValueError(f"client_parallelism={mode!r}; "
                         f"expected one of {PARALLELISM_MODES}")
    if fed.sampler not in sampling.SAMPLERS:
        raise ValueError(f"sampler={fed.sampler!r}; "
                         f"expected one of {sampling.SAMPLERS}")
    if fed.engine not in ENGINES:
        raise ValueError(f"engine={fed.engine!r}; expected one of {ENGINES}")
    if fed.chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1; got {fed.chunk_rounds}")
    if fed.engine not in ("scan", "async") and (fed.checkpoint_path
                                                or fed.resume):
        raise ValueError("checkpoint_path/resume require engine='scan' or "
                         "'async' (the eager engine does not checkpoint)")
    if fed.engine == "async":
        if fed.straggler_frac > 0.0:
            raise ValueError(
                "engine='async' replaces the straggler drop mask with the "
                "latency model (FedConfig.latency); set straggler_frac=0")
        if mode == "loop":
            raise ValueError("engine='async' requires a vectorized "
                             "client_parallelism ('vmap'/'shard')")
        if fed.client_store != "device":
            raise ValueError("engine='async' currently requires "
                             "client_store='device'")
        sampling.LatencyModel(fed.latency, fed.latency_scale,
                              fed.latency_sigma)   # validates the knobs
    if fed.eval_every < 1:
        raise ValueError(f"eval_every must be >= 1; got {fed.eval_every}")
    if fed.client_store not in client_store.STORE_BACKENDS:
        raise ValueError(f"client_store={fed.client_store!r}; expected one "
                         f"of {client_store.STORE_BACKENDS}")
    if fed.client_store != "device" and mode == "loop":
        raise ValueError(f"client_store={fed.client_store!r} requires a "
                         f"vectorized client_parallelism ('vmap'/'shard'); "
                         f"the loop path is the device-store reference")
    sampling.n_sampled(fed.n_clients, fed.participation)   # validates
    if not 0.0 <= fed.straggler_frac < 1.0:
        raise ValueError(f"straggler_frac must be in [0, 1); "
                         f"got {fed.straggler_frac}")
    if n_train != fed.n_clients:
        raise ValueError(f"n_clients={fed.n_clients} but {n_train} client "
                         f"training sets were provided")
    compress.get_codec(fed.uplink_codec)              # validates
    faults.fault_model_of(fed)                        # validates
    if admission.control_of(fed).enabled and strategy.aggregate == "none":
        raise ValueError(f"admission control needs an aggregating method; "
                         f"method={fed.method!r} has no uplink to admit")
    if fed.dispatch_timeout < 0:
        raise ValueError(f"dispatch_timeout must be >= 0; "
                         f"got {fed.dispatch_timeout}")
    if fed.dispatch_timeout > 0 and fed.engine != "async":
        raise ValueError("dispatch_timeout is the async engine's upload "
                         f"timeout; engine={fed.engine!r} has no virtual "
                         "clock to time out on")
    if fed.retry_backoff <= 0:
        raise ValueError(f"retry_backoff must be > 0; got {fed.retry_backoff}")
    if fed.retry_cap < 0:
        raise ValueError(f"retry_cap must be >= 0; got {fed.retry_cap}")


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def run_federated(task: FedTask, fed: FedConfig, client_train: list,
                  client_test: list, *, device="cuda",
                  init_clients: Optional[Sequence[dict]] = None,
                  cka_probes: Optional[torch.Tensor] = None,
                  gmm_init: Optional[GmmInit] = None,
                  sr_uniforms: Optional[Callable[[int, int],
                                                 compress.Uniforms]] = None,
                  verbose: bool = False) -> dict:
    """Run Algorithm 1 for ``fed.rounds`` rounds on ``device``; returns the
    history plus the final per-client states, as the JAX package does.

    ``task.base`` must lie on ``device``.  ``init_clients`` (m dicts of
    {'adapter', 'head'} as :meth:`FedTask.init_client` makes them),
    ``cka_probes`` ((fed.cka_probes, r) f32), ``gmm_init`` (a callable
    (client, category, n) → G distinct row indices) and ``sr_uniforms`` (a
    callable (round, client) → the codec's uniforms,
    :data:`compress.Uniforms`) replace the default draws from generators
    seeded with ``fed.seed``."""
    strategy = get_strategy(fed.method)
    _validate(fed, strategy, len(client_train))
    dev = resolve_device(device)
    check_on(task.base, dev, "task.base")
    m = fed.n_clients
    impl = fed.attn_impl if fed.attn_impl is not None else task.cfg.attn_impl
    if impl not in attention.IMPLS:
        raise ValueError(f"attn_impl={impl!r}; "
                         f"expected one of {attention.IMPLS}")
    fed = dataclasses.replace(fed, attn_impl=impl)
    # the programs are anchored on the caller's backbone and config (impl
    # rides in their key): the override below makes a new config object
    # every call, which would never hit
    anchors = (task.base, task.cfg)
    if task.cfg.attn_impl != impl:
        task = task._replace(cfg=task.cfg.with_overrides(attn_impl=impl))

    if init_clients is None:
        gen = torch.Generator(device=dev).manual_seed(fed.seed)
        init_clients = [task.init_client(gen) for _ in range(m)]
    if len(init_clients) != m:
        raise ValueError(f"{len(init_clients)} initial clients for "
                         f"n_clients={m}")
    for c in init_clients:
        check_on(c, dev, "init_clients")
    states = [strategy.init_state(dict(c)) for c in init_clients]
    codec = compress.get_codec(fed.uplink_codec)
    compressed = not codec.is_identity and strategy.aggregate != "none"
    if compressed:
        states = [dict(s, ef=compress.init_ef(strategy.uplink(s)))
                  for s in states]
        sr_uniforms = sr_uniforms or (
            lambda rnd, i: compress.client_generator(fed.seed, rnd, i))
    if fed.client_store == "host":
        # the population is host-resident from the start: the device holds
        # the cohort, never the population
        states = [tree_map(lambda t: t.detach().cpu(), s) for s in states]
    loaders = [Loader(client_train[i], fed.batch_size, seed=fed.seed + i)
               for i in range(m)]
    sample_counts = [len(d["labels"]) for d in client_train]
    opt = adamw(lr=fed.lr)

    partial = fed.participation < 1.0 or fed.straggler_frac > 0.0
    plans = [sampling.build_plan(fed.sampler, m, fed.participation,
                                 fed.straggler_frac, rnd, fed.seed,
                                 sample_counts) if partial
             else sampling.full_plan(m, rnd)
             for rnd in range(fed.rounds)]

    def local_fit(trainable: dict, w_ref: Any, toks: torch.Tensor,
                  labs: torch.Tensor):
        """``fed.local_steps`` AdamW steps (a fresh optimizer state per
        round, as in the JAX package) over the stacked (steps, B, T)
        batches; gradients only for the strategy's trainable factors."""
        mask = strategy.grad_mask(trainable)
        opt_state = opt.init(trainable)
        losses = []
        for step in range(toks.shape[0]):
            tr = tree_map(lambda t, on: t.detach().requires_grad_(on),
                          trainable, mask)
            loss, _ = task.loss({"adapter": strategy.effective_adapter(tr),
                                 "head": tr["head"]}, toks[step], labs[step])
            if strategy.prox:
                loss = loss + strategy.local_penalty(tr, {"w": w_ref})
            wrt = [t for t in tree_leaves(tr) if t.requires_grad]
            grads = dict(zip(map(id, wrt), torch.autograd.grad(loss, wrt)))
            upd, opt_state = opt.update(
                tree_map(lambda t: grads.get(id(t)), tr), opt_state,
                trainable)
            trainable = apply_updates(trainable, upd)
            losses.append(loss.detach())
        return trainable, torch.stack(losses).mean()

    vopt = adamw(lr=fed.lr, stacked=True)

    def local_fit_stacked(trainable: dict, w_ref: Any, toks: torch.Tensor,
                          labs: torch.Tensor):
        """All m clients' ``local_fit`` as one batch: toks (m, steps, B,
        T).  The scalar differentiated is the sum of the m per-client
        losses, so each client's leaves get exactly their own gradient;
        returns each client's mean loss (m,)."""
        mask = strategy.grad_mask(trainable)
        opt_state = vopt.init(trainable)
        losses = []
        for step in range(toks.shape[1]):
            tr = tree_map(lambda t, on: t.detach().requires_grad_(on),
                          trainable, mask)
            loss, _ = task.loss({"adapter": strategy.effective_adapter(tr),
                                 "head": tr["head"]}, toks[:, step],
                                labs[:, step])
            if strategy.prox:
                loss = loss + strategy.local_penalty(tr, {"w": w_ref},
                                                     stacked=True)
            wrt = [t for t in tree_leaves(tr) if t.requires_grad]
            grads = dict(zip(map(id, wrt), torch.autograd.grad(
                loss.sum(), wrt)))
            upd, opt_state = vopt.update(
                tree_map(lambda t: grads.get(id(t)), tr), opt_state,
                trainable)
            trainable = apply_updates(trainable, upd)
            losses.append(loss.detach())
        return trainable, torch.stack(losses).mean(0)

    pad_to = max(-(-len(d["labels"]) // 32) * 32 for d in client_test)
    seq_lens = {d["tokens"].shape[1] for d in client_test}
    if len(seq_lens) != 1:
        raise ValueError(
            "run_federated requires one shared test sequence length across "
            f"clients (the eval batch stacks to (m, pad, T)); got {seq_lens}")
    seq_len = seq_lens.pop()
    tk = np.zeros((m, pad_to, seq_len), np.int32)
    lb = np.full((m, pad_to), -1, np.int32)
    for i, d in enumerate(client_test):
        n = len(d["labels"])
        tk[i, :n] = d["tokens"]
        lb[i, :n] = d["labels"]
    if fed.client_store == "host":
        # the host store streams the test stacks through the device in
        # slabs: the (m, pad, T) stack stays on the host
        test_toks, test_labs = tk, lb
    else:
        test_toks = torch.as_tensor(tk, device=dev)
        test_labs = torch.as_tensor(lb, device=dev)

    @torch.no_grad()
    def eval_stacked(trainable: dict, toks: torch.Tensor,
                     labs: torch.Tensor) -> torch.Tensor:
        """Accuracy over padded test sets (label -1 = pad), on the device:
        one client's (pad, T) → (), or all m clients' stacked (m, pad, T)
        in one call → (m,)."""
        logits = task.logits(strategy.effective_adapter(trainable),
                             trainable["head"], toks)
        w = (labs >= 0).float()
        correct = (torch.argmax(logits, -1) == labs).float() * w
        return correct.sum(-1) / w.sum(-1).clamp_min(1.0)

    # the programs of the fit and the eval, cached across run_federated
    # calls on the task (a CUDA graph a signature on a card; the function
    # itself on the CPU): every engine and store gets them from engine_kw
    mode = fed.client_parallelism
    fit_key = (strategy.name, fed.lr, fed.local_steps, fed.batch_size,
               fed.pfedme_eta, mode, impl)
    local_fit = jit_cache.jit(_LOCAL_FIT_CACHE, anchors, fit_key + ("one",),
                              local_fit)
    local_fit_stacked = jit_cache.jit(_LOCAL_FIT_CACHE, anchors,
                                      fit_key + ("stacked",),
                                      local_fit_stacked)
    eval_stacked = jit_cache.jit(_EVAL_CACHE, anchors,
                                 (strategy.name, pad_to, mode, impl),
                                 eval_stacked)

    def eval_acc(trainable: dict, toks: torch.Tensor,
                 labs: torch.Tensor) -> list:
        """:func:`eval_stacked` read back as a list of floats."""
        return eval_stacked(trainable, toks, labs).reshape(-1).tolist()

    s_data = None
    if strategy.aggregate == "personalized" and fed.use_data_sim:
        s_data = data_similarity(task, fed, client_train, gmm_init=gmm_init)

    if strategy.aggregate == "personalized" and fed.use_model_sim:
        if cka_probes is None:
            cka_probes = cka.draw_probes(
                torch.Generator(device=dev).manual_seed(fed.seed + 97),
                fed.cka_probes, task.cfg.lora_rank)
        cka_probes = torch.as_tensor(cka_probes, dtype=torch.float32,
                                     device=dev)

    # ---- store dispatch: the host-resident population runs its own
    # cohort round loop on both engines (repro_torch.core.client_store)
    engine_kw = dict(
        task=task, fed=fed, strategy=strategy, states=states,
        loaders=loaders, sample_counts=sample_counts, plans=plans,
        local_fit=local_fit_stacked, eval_acc=eval_stacked, s_data=s_data,
        test_toks=test_toks, test_labs=test_labs, cka_probes=cka_probes,
        sr_uniforms=sr_uniforms, device=dev, verbose=verbose)
    if fed.client_store == "host":
        return client_store.run_cohort(**engine_kw)

    # ---- engine dispatch: the scan engine runs the same round in chunks
    # of rounds (repro_torch.core.fed_engine), the async engine buffers
    # uploads on a virtual clock (repro_torch.core.async_engine); the eager
    # paths below are the reference both are held to
    if fed.engine == "async":
        from repro_torch.core import async_engine
        return async_engine.run_async(**engine_kw)
    if fed.engine == "scan":
        from repro_torch.core import fed_engine
        return fed_engine.run_scan(**engine_kw, anchors=anchors)

    s_model_prev: list = [None]

    def model_sim(cs: torch.Tensor, plan) -> torch.Tensor:
        """S^model: only the sampled clients' rows/columns are refreshed;
        unsampled pairs keep their cached CKA (both Cs frozen)."""
        s_model_prev[0] = cka.refresh_pairwise_cka(
            s_model_prev[0], cs, plan.sampled, cka_probes)
        return s_model_prev[0]

    def personalized(participants, model_sim_src) -> torch.Tensor:
        """Eqn (3) weights from S = S^data (+ S^model this round, from the
        callable ``model_sim_src``)."""
        sims = []
        if fed.use_data_sim and s_data is not None:
            sims.append(s_data)
        if fed.use_model_sim:
            sims.append(model_sim_src())
        if not sims:
            raise ValueError(
                f"celora needs at least one similarity term; got "
                f"use_data_sim={fed.use_data_sim}, "
                f"use_model_sim={fed.use_model_sim}")
        return aggregation.personalized_weights(sum(sims), fed.self_weight,
                                                participants)

    # ---- the robust round's setup, gated on `robust` so that the
    # fault-free config keeps the fault-free paths
    fm = faults.fault_model_of(fed)
    adm = admission.control_of(fed)
    robust = fm.active or adm.enabled
    adm_state = admission.init_state(adm.window, dev) if adm.enabled else None
    communicates = strategy.aggregate != "none"
    per_b = per_down_b = per_e = 0
    if robust and communicates:
        # per-client byte constants: the robust round prices bytes per sent
        # upload and per accepted downlink
        one = strategy.uplink(states[0])
        per_down_b, per_e = comm.tree_bytes(one), comm.tree_elems(one)
        per_b = per_down_b
        if compressed:
            meta = tree_map(lambda t: torch.empty((m,) + tuple(t.shape),
                                                  dtype=t.dtype,
                                                  device="meta"), one)
            per_b, per_e = comm.per_client_comm(
                compress.wire_struct(codec, meta, m))
    if robust and strategy.aggregate == "personalized" and fed.use_model_sim:
        # the row-masked refresh needs a valid previous S^model from round
        # 0: the initial Cs' (the JAX package's scan-engine init)
        s_model_prev[0] = cka.pairwise_model_similarity(
            [strategy.uplink(s) for s in states], cka_probes)

    def masked_refresh(cs: torch.Tensor, sampled_ids, accept: torch.Tensor,
                       smask: torch.Tensor) -> torch.Tensor:
        """Robust S^model: refresh the rows of ACCEPTED clients only; a pair
        touching a sampled client whose upload was not accepted (its served
        C is stale, corrupt or undelivered) keeps its previous entry."""
        refreshed = cka.refresh_rows_inline(s_model_prev[0], cs, sampled_ids,
                                            cka_probes)
        clean = ~smask | accept
        valid = ((accept[:, None] & clean[None, :])
                 | (accept[None, :] & clean[:, None]))
        s_model_prev[0] = torch.where(valid, refreshed, s_model_prev[0])
        return s_model_prev[0]

    def outcome(plan, fd) -> tuple:
        """(sent, delivered, corrupted, divergent) (m,) bool masks of a
        round: sent left the device, delivered reached the server."""
        pmask = plan.mask(m)
        if fd is None:
            none = np.zeros(m, bool)
            return pmask, pmask, none, none
        sent = pmask & ~fd.crash
        delivered = sent & ~fd.loss
        return (sent, delivered, delivered & fd.corrupt,
                plan.mask(m, which="sampled") & fd.divergent)

    def robust_comm(sent: np.ndarray, accept: np.ndarray) -> comm.RoundComm:
        return comm.RoundComm(uplink_bytes=per_b * int(sent.sum()),
                              downlink_bytes=per_down_b * int(accept.sum()),
                              uplink_elems=per_e * int(sent.sum()))

    def gate(served_stacked, delivered: np.ndarray) -> np.ndarray:
        """The accepted rows: the delivered ones the admission gate passes
        (all delivered with admission off), read back once a round."""
        nonlocal adm_state
        if not adm.enabled:
            return delivered
        norms, finite = admission.payload_stats(served_stacked)
        acc, adm_state = admission.admit(norms, finite, delivered, adm_state,
                                         adm)
        return acc.cpu().numpy()

    def record(rnd, losses, accs, rc, plan, t0, evaluated, fd, delivered,
               accept) -> RoundRecord:
        rec = _round_record(rnd, losses, accs, rc, plan, t0,
                            evaluated=evaluated)
        if robust:
            rec.rejected = np.nonzero(delivered & ~accept)[0].tolist()
        if fd is not None:
            rec.failed = np.nonzero(plan.mask(m) & (fd.crash | fd.loss))[
                0].tolist()
        return rec

    history: list[RoundRecord] = []
    accs = [0.0] * m        # replaced on round 0 (always an eval round)
    if fed.client_parallelism == "loop":
        for rnd in range(fed.rounds):
            plan = plans[rnd]
            t0 = time.perf_counter()
            in_sample = plan.mask(m, which="sampled")
            fd = fm.draw(m, rnd, fed.seed) if fm.active else None
            losses = []
            for i in range(m):
                # ALWAYS draw: keeps the per-client data streams aligned
                # with the vectorized path and across participation rates
                bt = list(loaders[i].batches(fed.local_steps))
                if not in_sample[i]:
                    continue                # unsampled: frozen this round
                toks = torch.as_tensor(np.stack([b["tokens"] for b in bt]),
                                       device=dev)
                labs = torch.as_tensor(np.stack([b["labels"] for b in bt]),
                                       device=dev)
                prev_state = dict(states[i]) if fd is not None else None
                tr, loss = local_fit(strategy.trainable(states[i]),
                                     states[i].get("w", {}), toks, labs)
                states[i].update(tr)
                states[i] = strategy.after_local(states[i], fed.pfedme_eta)
                losses.append(float(loss))
                if fd is not None and (fd.crash[i] or fd.divergent[i]):
                    # crash: the round's local work is lost; divergent: the
                    # client's divergence detection restarts from the
                    # round start
                    states[i] = prev_state

            sent, delivered, corrupted, divergent = outcome(plan, fd)
            cmask = (torch.as_tensor(plan.mask(m), device=dev) if partial
                     else None)
            payloads = [strategy.uplink(s) for s in states]
            if communicates:
                for i in np.nonzero(divergent)[0]:
                    payloads[i] = tree_map(
                        lambda l: l * fm.divergent_scale, payloads[i])
            if compressed:
                # encode all m (the JAX package keys every client's draw),
                # price the participants' ENCODED trees, aggregate the
                # dequantized payloads, advance the residual of delivered
                # uploads only
                encoded = [compress.encode_client(codec, payloads[i],
                                                  states[i]["ef"],
                                                  sr_uniforms(rnd, i))
                           for i in range(m)]
                served = [e[1] for e in encoded]
                if not robust:
                    rc = comm.round_comm_compressed_payloads(
                        [encoded[i][0] for i in plan.participants],
                        [payloads[i] for i in plan.participants])
                    for i in plan.participants:
                        states[i] = dict(states[i], ef=encoded[i][2])
            else:
                served = list(payloads)
                if not (robust and communicates):
                    rc = comm.round_comm_payloads(
                        [payloads[i] for i in plan.participants])
            if communicates:
                for i in np.nonzero(corrupted)[0]:
                    served[i] = faults.corrupt_one(
                        codec if compressed else None,
                        encoded[i][0] if compressed else None, served[i],
                        fm.corrupt_mode)
            accept = delivered
            if robust and communicates:
                accept = gate(client_batch.stack_states(served)
                              if adm.enabled else None, delivered)
                cmask = torch.as_tensor(accept, device=dev)
                if compressed:
                    # EF advances for ACCEPTED uploads only: a rejection
                    # rolls the residual back by never installing the new
                    for i in np.nonzero(accept)[0]:
                        states[i] = dict(states[i], ef=encoded[i][2])
                rc = robust_comm(sent, accept)
            weights = None
            if strategy.aggregate == "personalized":
                c_trees = served if compressed or robust else [
                    tri_lora.tree_payload(s["adapter"]) for s in states]
                if robust:
                    weights = personalized(cmask, lambda: masked_refresh(
                        cka.stack_client_cs(c_trees), plan.sampled, cmask,
                        torch.as_tensor(in_sample, device=dev)))
                else:
                    weights = personalized(cmask, lambda: model_sim(
                        cka.stack_client_cs(c_trees), plan))
            install_ids = plan.participants
            if robust and communicates:
                # rejected or undelivered rows may hold NaN/Inf: their
                # weight is 0, but 0 x NaN still poisons the mix
                for i in np.nonzero(~accept)[0]:
                    served[i] = tree_map(torch.zeros_like, served[i])
                install_ids = np.nonzero(accept)[0]
            downs = strategy.server(served, sample_counts=sample_counts,
                                    weights=weights, participants=cmask)
            for i in install_ids:
                states[i] = strategy.install(states[i], downs[i])

            evaluated = _do_eval(rnd, fed)
            if evaluated:
                accs = [eval_acc(strategy.trainable(states[i]),
                                 test_toks[i], test_labs[i])[0]
                        for i in range(m)]
            history.append(record(rnd, losses, accs, rc, plan, t0, evaluated,
                                  fd, delivered, accept))
            if verbose:
                _print_round(strategy, history[-1])
    else:
        # ---- vectorized path: one batched local fit, one stacked server
        # step and one eval call per round; the device store holds the
        # stacked population
        pstore = client_store.make_store(fed.client_store, states,
                                         parallelism=fed.client_parallelism,
                                         device=dev)
        stacked = pstore.resident()

        for rnd in range(fed.rounds):
            plan = plans[rnd]
            t0 = time.perf_counter()
            toks, labs = client_batch.stack_client_batches(
                loaders, fed.local_steps, device=dev)
            t_fetch = time.perf_counter()
            # all m train (one batch); the select below freezes the
            # unsampled clients' state exactly
            tr, losses = local_fit_stacked(
                strategy.trainable(stacked), stacked.get("w", {}),
                toks, labs)
            in_sample = plan.mask(m, which="sampled")
            fd = fm.draw(m, rnd, fed.seed) if fm.active else None
            sent, delivered, corrupted, divergent = outcome(plan, fd)
            trained = strategy.after_local(dict(stacked, **tr),
                                           fed.pfedme_eta)
            if partial or fd is not None:
                keep = in_sample
                if fd is not None:
                    # crash: the round's local work is lost; divergent:
                    # the client restarts from the round start
                    keep = keep & ~fd.crash & ~fd.divergent
                stacked = client_batch.select_clients(keep, trained, stacked)
            else:
                stacked = trained

            cmask = (torch.as_tensor(plan.mask(m), device=dev) if partial
                     else None)
            payload = strategy.uplink(stacked)       # stacked tree or None
            if payload is not None and divergent.any():
                payload = faults.scale_rows(payload, divergent,
                                            fm.divergent_scale)
            enc = None
            if compressed:
                enc, served, ef_new = compress.encode_stacked(
                    codec, payload, stacked["ef"],
                    [sr_uniforms(rnd, i) for i in range(m)])
                rc = comm.round_comm_compressed_stacked(
                    enc, payload, plan.n_participants)
                if not robust:
                    stacked = dict(stacked, ef=(
                        client_batch.select_clients(cmask, ef_new,
                                                    stacked["ef"])
                        if partial else ef_new))
            else:
                served = payload
                rc = comm.round_comm_stacked(payload, plan.n_participants)
            if payload is not None and corrupted.any():
                served = faults.corrupt_served(
                    codec if compressed else None, enc, served, corrupted,
                    fm.corrupt_mode)
            accept = delivered
            if robust and payload is not None:
                accept = gate(served, delivered)
                cmask = torch.as_tensor(accept, device=dev)
                if compressed:
                    # EF advances for ACCEPTED uploads only
                    stacked = dict(stacked, ef=client_batch.select_clients(
                        cmask, ef_new, stacked["ef"]))
                rc = robust_comm(sent, accept)
            weights = None
            if strategy.aggregate == "personalized":
                c_tree = served if compressed or robust else \
                    tri_lora.tree_payload(stacked["adapter"])
                if robust:
                    weights = personalized(cmask, lambda: masked_refresh(
                        cka.stacked_cs(c_tree), plan.sampled, cmask,
                        torch.as_tensor(in_sample, device=dev)))
                else:
                    weights = personalized(cmask, lambda: model_sim(
                        cka.stacked_cs(c_tree), plan))
            if robust and payload is not None:
                # rejected or undelivered rows may hold NaN/Inf: their
                # weight is 0, but 0 x NaN still poisons the mix
                served = faults.zero_rows(served, cmask)
            down = strategy.server_stacked(served,
                                           sample_counts=sample_counts,
                                           weights=weights,
                                           participants=cmask)
            installed = strategy.install(stacked, down)
            stacked = (client_batch.select_clients(cmask, installed, stacked)
                       if (partial or robust) and down is not None
                       else installed)

            evaluated = _do_eval(rnd, fed)
            if evaluated:
                accs = eval_acc(strategy.trainable(stacked), test_toks,
                                test_labs)
            history.append(record(
                rnd, losses.cpu().numpy()[plan.sampled], accs, rc, plan, t0,
                evaluated, fd, delivered, accept))
            history[-1].host_s = t_fetch - t0
            history[-1].device_s = history[-1].wall_s - (t_fetch - t0)
            if verbose:
                _print_round(strategy, history[-1])
        pstore.adopt(stacked)
        states = pstore.unstack()

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
        "states": states,
    }


def _do_eval(rnd: int, fed: FedConfig) -> bool:
    """Eval cadence: every ``eval_every``-th round plus the last."""
    return rnd % fed.eval_every == 0 or rnd == fed.rounds - 1


def _round_record(rnd: int, losses, accs: list, rc: comm.RoundComm,
                  plan: sampling.ParticipationPlan, t0: float,
                  evaluated: bool = True) -> RoundRecord:
    return RoundRecord(
        rnd, float(np.mean(losses)), accs,
        uplink_bytes=rc.uplink_bytes, downlink_bytes=rc.downlink_bytes,
        wall_s=time.perf_counter() - t0,
        participants=plan.participants.tolist(),
        sampled=plan.sampled.tolist(), dropped=plan.dropped.tolist(),
        uplink_elems=rc.uplink_elems, evaluated=evaluated)


def _print_round(strategy: Strategy, rec: RoundRecord) -> None:
    print(f"[{strategy.name}] round {rec.round:3d} loss {rec.train_loss:.4f}"
          f" acc {rec.mean_acc:.3f} (min {rec.min_acc:.3f}"
          f" max {rec.max_acc:.3f}) up {rec.uplink_bytes}B"
          f" ({len(rec.participants)}/{len(rec.accs)} clients)")
