"""The port's scan engine (``repro_torch.core.fed_engine``, ``run_federated``
with ``engine="scan"``) on the CPU.

Against the JAX package's scan engine, its direct counterpart (the JAX
eager and scan engines part by float order past round 2, so the eager
engine is not the reference here): the tiny config of
tests/test_torch_federated.py, the JAX runs' own draws (client init, CKA
probes, GMM initial means, the codec's uniforms) handed to the port, and
the JAX package's contract — identical sampled / participant / dropped /
failed / rejected lists, ``evaluated`` flags and byte and element ledgers,
loss within 1e-4, accuracies within 1e-3, states within 5e-4:

* (i) celora at participation 0.5, int8, a seeded fault storm (seed 14:
  crashes, lost, NaN-corrupted and divergent uploads among the sampled
  clients) and the norm gate, ``eval_every=2``, 4 rounds in chunks of 2;
* (ii) the same run killed at 2 rounds, writing a checkpoint, which the
  port resumes to 4 rounds and holds to (i);
* (iii) ``pfedme_lora`` with stragglers (prox plus FedAvg).

The three JAX runs share two compiled chunk programs ((i) and (ii) differ
only in ``rounds``).  Port against port, bitwise: chunk sizes, the chunk
program against round-by-round dispatch (one program a chunk length and
cadence pattern), donate/prefetch, a repeated donated run,
kill-and-resume, the released carry; then the scan engine against the
port's eager vmap path, the chunk feeders against the JAX package's
numpy, and the ChunkPrefetcher contract (tests/test_pipeline.py
mirrored).
"""
import collections
import dataclasses
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.core import client_batch as jclient_batch
from repro.core import compress as jcompress
from repro.core import fed_engine as jfed_engine
from repro.core import federated as jfed
from repro.core import sampling as jsampling
from repro.core.fed_model import FedTask as JFedTask
from repro.data import synthetic as jsynthetic
from repro.data.pipeline import Loader as JLoader
from repro.models.config import ModelConfig as JConfig
from repro_torch import checkpoint, convert
from repro_torch.core import (client_batch, fed_engine, federated,
                              jit_cache, sampling)
from repro_torch.data.pipeline import Loader
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
M, CLASSES = 4, 2
FED = dict(n_clients=M, local_steps=2, batch_size=8, lr=1e-2, seed=14,
           feature_samples=24, cka_probes=16, gmm_iters=10, engine="scan",
           chunk_rounds=2)
STORM = dict(fault_crash=0.15, fault_loss=0.2, fault_corrupt=0.25,
             fault_divergent=0.15, admission="norm")
JAX_RUNS = {
    "storm": dict(FED, method="celora", participation=0.5,
                  uplink_codec="int8", eval_every=2, rounds=4, **STORM),
    "killed": dict(FED, method="celora", participation=0.5,
                   uplink_codec="int8", eval_every=2, rounds=2, **STORM),
    "pfedme": dict(FED, method="pfedme_lora", straggler_frac=0.3, rounds=3,
                   seed=1),
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ctrain, ctest, _ = jsynthetic.make_federated_classification(
        0, M, 40, 12, 16, TINY["vocab_size"], CLASSES, drift=0.8)
    jcfg = JConfig(**TINY)
    base = jax.jit(lambda k: JFedTask.create(k, jcfg, CLASSES).base)(
        jax.random.key(0))
    jtask = JFedTask(jcfg, base, CLASSES)
    task = convert.fed_task_from_numpy(ModelConfig(**TINY),
                                       jax.tree.map(np.asarray, base),
                                       CLASSES, "cpu")
    return {"jtask": jtask, "task": task, "ctrain": ctrain, "ctest": ctest,
            "dir": tmp_path_factory.mktemp("scan"), "memo": {}}


def _jax_run(setup, name):
    memo = setup["memo"]
    if name not in memo:
        kw = dict(JAX_RUNS[name])
        if name == "killed":
            kw["checkpoint_path"] = str(setup["dir"] / "jax_killed.npz")
        memo[name] = jfed.run_federated(setup["jtask"], jfed.FedConfig(**kw),
                                        setup["ctrain"], setup["ctest"])
    return memo[name]


def _draws(setup, kw):
    """The JAX runtime's draws for config ``kw``: client init, CKA probes,
    GMM initial means, and the codec's uniforms per (round, client)."""
    jtask, seed = setup["jtask"], kw["seed"]
    ckeys = jax.random.split(jax.random.key(seed), M)
    clients = [convert.params_from_numpy(jax.tree.map(
        np.asarray, jtask.init_client(ckeys[i])), "cpu") for i in range(M)]
    probes = torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(seed + 97), (kw["cka_probes"], TINY["lora_rank"]),
        jnp.float32)))

    def gmm_init(ci, k, n):
        return np.asarray(jax.random.choice(
            jax.random.key(seed + 31 * ci + k), n, (2,), replace=False))
    out = dict(init_clients=clients, cka_probes=probes, gmm_init=gmm_init)
    if kw.get("uplink_codec", "none") != "none":
        codec = jcompress.get_codec(kw["uplink_codec"])
        like = federated.get_strategy(kw["method"]).uplink(clients[0])
        sizes = [int(t.numel()) for t in tree_leaves(like)]

        def uniforms(rnd, i):
            keys = jax.random.split(jcompress.client_key(seed, rnd, i),
                                    len(sizes))
            return [torch.from_numpy(np.array(jax.random.uniform(
                k, (-(-n // jcompress._leaf_tile(n, codec.pack)),
                    jcompress._leaf_tile(n, codec.pack)))))
                for n, k in zip(sizes, keys)]
        out["sr_uniforms"] = uniforms
    return out


def _port(setup, kw, draws=None, **over):
    fed = federated.FedConfig(**{**kw, **over})
    return federated.run_federated(setup["task"], fed, setup["ctrain"],
                                   setup["ctest"], device="cpu",
                                   **(draws or {}))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _paths(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}/{i}"))
    elif tree is not None:
        out[prefix] = tree
    return out


LEDGER = ("round", "sampled", "participants", "dropped", "failed",
          "rejected", "evaluated", "uplink_bytes", "downlink_bytes",
          "uplink_elems")


def _assert_contract(ref_hist, out_hist, ref_states=None, out_states=None):
    """The JAX package's engine contract (tests/test_fed_engine.py)."""
    assert len(ref_hist) == len(out_hist)
    for a, b in zip(ref_hist, out_hist):
        assert [getattr(a, k) for k in LEDGER] == \
            [getattr(b, k) for k in LEDGER]
        assert abs(a.train_loss - b.train_loss) < 1e-4, a.round
        np.testing.assert_allclose(a.accs, b.accs, atol=1e-3)
    for s_ref, s_out in zip(ref_states or (), out_states or ()):
        want, got = _paths(jax.tree.map(_np, s_ref)), _paths(s_out)
        assert want.keys() == got.keys()
        for k, v in want.items():
            np.testing.assert_allclose(_np(got[k]), v, atol=5e-4,
                                       err_msg=k)


def _assert_bitwise(a, b):
    """Two port runs: every history field but the times, and every state
    leaf, bit for bit."""
    times = ("wall_s", "host_s", "device_s")
    for ra, rb in zip(a["history"], b["history"], strict=True):
        fa = {k: v for k, v in vars(ra).items() if k not in times}
        fb = {k: v for k, v in vars(rb).items() if k not in times}
        assert fa == fb
    for sa, sb in zip(a["states"], b["states"], strict=True):
        la, lb = _paths(sa), _paths(sb)
        assert la.keys() == lb.keys()
        assert all(torch.equal(la[k], lb[k]) for k in la)


# ---------------------------------------------------------------------------
# against the JAX package's scan engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_scan_matches_jax_scan(setup, name):
    ref = _jax_run(setup, name)
    kw = JAX_RUNS[name]
    if name != "pfedme":
        hist = _jax_run(setup, "storm")["history"]
        assert any(r.failed for r in hist) and any(r.rejected for r in hist)
        assert not all(r.evaluated for r in hist)
    out = _port(setup, kw, _draws(setup, kw))
    _assert_contract(ref["history"], out["history"], ref["states"],
                     out["states"])


def test_port_resumes_the_jax_checkpoint(setup, tmp_path):
    """The JAX package's chunk-boundary checkpoint of run (ii) resumes in
    the port and continues run (i).  Rounds 0-1 of the resumed history are
    the checkpoint's, as in the JAX package's own resume: run (ii) ended
    at round 1, so round 1 was evaluated there (the last round always is)
    while run (i) carries round 0's accuracies, and only (ii)'s rows can
    be restored."""
    killed, full = _jax_run(setup, "killed"), _jax_run(setup, "storm")
    path = tmp_path / "resumed.npz"
    shutil.copy(setup["dir"] / "jax_killed.npz", path)
    checkpoint.verify(str(path))
    assert checkpoint.metadata(str(path))["rounds_done"] == 2
    kw = JAX_RUNS["storm"]
    out = _port(setup, kw, _draws(setup, kw), checkpoint_path=str(path),
                resume=True)
    hist = out["history"]
    for a, b in zip(killed["history"], hist[:2]):
        assert (a.train_loss, a.accs) == (b.train_loss, b.accs)
    _assert_contract(full["history"][2:], hist[2:], full["states"],
                     out["states"])
    assert checkpoint.metadata(str(path))["rounds_done"] == 4


def test_fingerprint_matches_jax():
    """The same FedConfig fingerprints alike in both packages, so that a
    checkpoint of either resumes in the other."""
    assert fed_engine._FINGERPRINT_FIELDS == jfed_engine._FINGERPRINT_FIELDS
    assert fed_engine.ROBUSTNESS_DEFAULTS == jfed_engine.ROBUSTNESS_DEFAULTS
    kw = dict(JAX_RUNS["storm"], attn_impl=None)
    assert fed_engine._fingerprint(federated.FedConfig(**kw)) == \
        jfed_engine._fingerprint(jfed.FedConfig(**kw))


# ---------------------------------------------------------------------------
# port against port, bitwise
# ---------------------------------------------------------------------------

#: the bitwise jobs: the storm run (i) at 3 rounds, default draws
PORT = dict(JAX_RUNS["storm"], rounds=3, eval_every=1)


def _port_memo(setup, key, **over):
    memo = setup["memo"]
    if key not in memo:
        memo[key] = _port(setup, PORT, **over)
    return memo[key]


@pytest.mark.parametrize("chunk", [1, 2])
def test_chunk_sizes_are_bitwise_alike(setup, chunk):
    ref = _port_memo(setup, "port chunk 7", chunk_rounds=7)
    _assert_bitwise(ref, _port_memo(setup, f"port chunk {chunk}",
                                    chunk_rounds=chunk))


@pytest.mark.parametrize("donate,prefetch",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
def test_donate_and_prefetch_are_bitwise_alike(setup, donate, prefetch):
    ref = _port_memo(setup, "port chunk 2", chunk_rounds=2)
    _assert_bitwise(ref, _port(setup, PORT, scan_donate=donate,
                               scan_prefetch=prefetch))


@pytest.mark.parametrize("rounds,every,programs", [(3, 1, 2), (5, 3, 3)],
                         ids=["every_round", "every_3rd"])
def test_chunk_program_equals_round_by_round_dispatch(setup, rounds, every,
                                                      programs):
    """The chunk program (on the CPU the chunk function) against the
    rounds dispatched one by one, plain (chunks of one round under
    ``disable_jit``): bitwise.  A run in chunks of 2 builds one program a
    (chunk length, cadence pattern): 3 rounds evaluating every round, (T,
    T) and (T); 5 rounds evaluating every 3rd and the last, (T, F), (F, T)
    and (T)."""
    kw = dict(PORT, rounds=rounds, eval_every=every, local_steps=1)
    jit_cache.clear_all()
    out = _port(setup, kw, chunk_rounds=2)
    assert len(fed_engine._SCAN_CACHE) == programs
    with jit_cache.disable_jit():
        ref = _port(setup, kw, chunk_rounds=1)
    _assert_bitwise(ref, out)
    jit_cache.clear_all()


def test_the_cache_holds_every_cadence_pattern_of_a_run(setup,
                                                        monkeypatch):
    """A run whose cadence patterns outnumber ``_SCAN_CACHE``'s size (9
    rounds in chunks of 2, evaluating every 3rd: (T, F), (F, T), (F, F),
    (T, F) again and (T)) grows the cache to hold them all: four programs,
    none built twice, and a second run builds nothing."""
    kw = dict(PORT, rounds=9, eval_every=3, local_steps=1)
    jit_cache.clear_all()
    monkeypatch.setattr(fed_engine, "_SCAN_CACHE",
                        jit_cache.JitCache(maxsize=2))
    built, program = [], jit_cache.program

    def counted(fn, args, donate_argnums=()):
        built.append(getattr(getattr(fn, "func", fn), "__name__", ""))
        return program(fn, args, donate_argnums)
    monkeypatch.setattr(jit_cache, "program", counted)
    _port(setup, kw, chunk_rounds=2)
    assert built.count("chunk_fn") == len(fed_engine._SCAN_CACHE) == 4
    _port(setup, kw, chunk_rounds=2)
    assert built.count("chunk_fn") == 4
    jit_cache.clear_all()


def test_loop_parallelism_runs_the_same_stacked_round(setup):
    """With the scan engine ``client_parallelism="loop"`` only places the
    population: the round is the stacked one, bit for bit."""
    _assert_bitwise(_port_memo(setup, "port chunk 2", chunk_rounds=2),
                    _port(setup, PORT, client_parallelism="loop"))


def test_donated_run_is_repeatable(setup):
    """Two donating runs from the same initial states: a chunk that read a
    released carry would raise or change the history."""
    _assert_bitwise(_port(setup, PORT, scan_donate=True),
                    _port(setup, PORT, scan_donate=True))


def test_released_carry_raises_and_shared_leaves_survive():
    old = {"a": torch.ones(5), "frozen": torch.arange(3.0),
           "view_of": torch.zeros(4), "sub": (torch.full((2,), 7.0),)}
    new = {"a": old["a"] + 1, "frozen": old["frozen"],
           "view_of": old["view_of"][1:], "sub": (old["sub"][0] * 2,)}
    assert client_batch.release(old, new) == 2
    for k in ("a",):
        with pytest.raises(RuntimeError, match="released"):
            old[k] + 1
    with pytest.raises(RuntimeError, match="released"):
        old["sub"][0].sum()
    assert torch.equal(new["frozen"], torch.arange(3.0))
    assert torch.equal(old["frozen"], torch.arange(3.0))    # the same tensor
    assert torch.equal(new["view_of"], torch.zeros(3))
    assert torch.equal(new["a"], torch.full((5,), 2.0))
    assert client_batch.release(old, new) == 0            # idempotent


def test_kill_and_resume_is_bitwise(setup, tmp_path):
    """Killed at 4 rounds and resumed to 6 is the uninterrupted 6-round run,
    bit for bit, and the chunk-boundary saves leave one file behind."""
    kw = dict(PORT, rounds=6, local_steps=1)
    path = str(tmp_path / "state.npz")
    full = _port(setup, kw)
    _port(setup, kw, rounds=4, checkpoint_path=path)
    resumed = _port(setup, kw, checkpoint_path=path, resume=True)
    _assert_bitwise(full, resumed)
    assert os.listdir(tmp_path) == ["state.npz"]
    assert checkpoint.metadata(path)["rounds_done"] == 6


def test_resume_refuses_a_changed_seed(setup, tmp_path):
    path = str(tmp_path / "state.npz")
    kw = dict(PORT, rounds=1, local_steps=1)
    _port(setup, kw, checkpoint_path=path)
    with pytest.raises(ValueError, match="different run configuration"):
        _port(setup, kw, seed=15, rounds=2, checkpoint_path=path,
              resume=True)


@pytest.mark.parametrize("method", ["celora", "fedpetuning"])
def test_scan_matches_the_eager_vmap_path(setup, method):
    kw = dict(FED, method=method, rounds=2, participation=0.5,
              use_data_sim=method == "celora")
    eager = _port(setup, kw, engine="eager", client_parallelism="vmap")
    scan = _port(setup, kw)
    _assert_contract(eager["history"], scan["history"],
                     [jax.tree.map(_np, s) for s in eager["states"]],
                     scan["states"])


class _HostReads(TorchFunctionMode):
    """Counts the calls that read a tensor back to the host or build one
    from host data: on a card, each is a sync or a synchronous copy."""
    READS = {"item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__", "__index__", "nonzero"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS or (name in ("as_tensor", "tensor",
                                           "from_numpy") and args
                                  and not isinstance(args[0], torch.Tensor)):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_rounds_inside_a_chunk_read_nothing_back(setup):
    """The CPU's view of the card's sync count: 2 rounds in one chunk and 4
    in one chunk make the same host reads (the chunk's inputs, its one
    read-back and the setup), so a round adds none."""
    counts = []
    for rounds in (2, 4):
        with _HostReads() as reads:
            _port(setup, PORT, rounds=rounds, chunk_rounds=rounds,
                  scan_prefetch=False)
        counts.append(reads.n)
    assert counts[0] == counts[1] > 0


def test_wall_split_recorded(setup):
    for prefetch in (False, True):
        out = _port(setup, PORT, local_steps=1, scan_prefetch=prefetch)
        for rec in out["history"]:
            assert rec.host_s >= 0.0 and rec.device_s > 0.0
            assert rec.host_s + rec.device_s <= rec.wall_s + 1e-6


# ---------------------------------------------------------------------------
# the chunk feeders against the JAX package's numpy
# ---------------------------------------------------------------------------

def test_stack_plans_matches_jax():
    for partial in (dict(participation=0.5, straggler_frac=0.3),
                    dict(participation=0.7, straggler_frac=0.0)):
        kw = dict(sampler="weighted", m=7, rnd=0, seed=3,
                  sample_counts=[5, 9, 2, 7, 7, 1, 4], **partial)
        plans = [sampling.build_plan(kw["sampler"], 7, kw["participation"],
                                     kw["straggler_frac"], r, 3,
                                     kw["sample_counts"]) for r in range(5)]
        jplans = [jsampling.build_plan(kw["sampler"], 7, kw["participation"],
                                       kw["straggler_frac"], r, 3,
                                       kw["sample_counts"]) for r in range(5)]
        ours, theirs = sampling.stack_plans(plans, 7), \
            jsampling.stack_plans(jplans, 7)
        for f in dataclasses.fields(theirs):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    bad = [sampling.full_plan(3, 0), sampling.build_plan("uniform", 3, 0.4,
                                                         0.0, 1, 0)]
    with pytest.raises(ValueError, match="round-invariant"):
        sampling.stack_plans(bad, 3)


def _loaders(cls, m=3, n=30, bs=4, seed=11):
    rng = np.random.default_rng(1)
    return [cls({"tokens": rng.integers(0, 50, (n, 6)).astype(np.int32),
                 "labels": rng.integers(0, 3, n).astype(np.int32)},
                bs, seed=seed + i) for i in range(m)]


def test_chunk_and_cohort_batches_match_jax():
    ours, theirs = _loaders(Loader), _loaders(JLoader)
    for n_rounds in (1, 3, 2):
        a = client_batch.stack_chunk_batches(ours, n_rounds, 2)
        b = jclient_batch.stack_chunk_batches(theirs, n_rounds, 2)
        for x, y in zip(a, b):
            assert x.dtype == torch.int32
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for ids in ([0, 2], [1]):
        a = client_batch.stack_cohort_batches(ours, np.asarray(ids), 3)
        b = jclient_batch.stack_cohort_batches(theirs, np.asarray(ids), 3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # the streams stay aligned after the skips
    a = client_batch.stack_client_batches(ours, 2, device="cpu")
    b = jclient_batch.stack_client_batches(theirs, 2)
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))


# ---------------------------------------------------------------------------
# ChunkPrefetcher (tests/test_pipeline.py's contract)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", [[1, 1, 1], [3, 3], [3, 3, 1]])
def test_chunk_prefetcher_matches_serial(schedule):
    serial = _loaders(Loader)
    ref = [client_batch.stack_chunk_batches(serial, n, 2) for n in schedule]
    pre = _loaders(Loader)
    pf = client_batch.ChunkPrefetcher(
        lambda n: client_batch.stack_chunk_batches(pre, n, 2), schedule)
    try:
        for rt, rl in ref:
            (toks, labs), produce_s = pf.get()
            assert produce_s >= 0.0
            assert torch.equal(toks, rt) and torch.equal(labs, rl)
        with pytest.raises(StopIteration):
            pf.get()
    finally:
        pf.close()


def test_chunk_prefetcher_bounded_queue():
    produced = []

    def produce(n):
        produced.append(n)
        return n
    pf = client_batch.ChunkPrefetcher(produce, [1] * 10, depth=2)
    time.sleep(0.3)
    assert len(produced) <= 3          # depth in the queue + one in flight
    assert pf.get()[0] == 1
    pf.close()
    n_after_close = len(produced)
    time.sleep(0.2)
    assert len(produced) == n_after_close


def test_chunk_prefetcher_propagates_errors():
    def produce(n):
        raise RuntimeError("loader exploded")
    pf = client_batch.ChunkPrefetcher(produce, [2])
    try:
        with pytest.raises(RuntimeError, match="loader exploded"):
            pf.get()
    finally:
        pf.close()


def test_chunk_prefetcher_get_after_close_raises():
    pf = client_batch.ChunkPrefetcher(lambda n: n, [1] * 4, depth=1)
    pf.get()
    pf.close()
    with pytest.raises(RuntimeError, match="after close"):
        pf.get()


def test_chunk_prefetcher_close_while_producer_blocked():
    started = threading.Event()

    def produce(n):
        started.set()
        return np.zeros(1 << 16)
    pf = client_batch.ChunkPrefetcher(produce, [1] * 50, depth=1)
    started.wait(timeout=5.0)
    time.sleep(0.1)                    # the producer blocks in _put
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError, match="after close"):
        pf.get()


def test_drive_chunks_closes_the_prefetcher_on_error():
    def dispatch(carry, batches, c0, c1):
        raise KeyError("dispatch failed")
    with pytest.raises(KeyError):
        client_batch.drive_chunks(0, [(0, 1), (1, 2)], lambda n: n,
                                  dispatch, lambda *a: None)
    assert not any(t.name == "chunk-prefetcher" and t.is_alive()
                   for t in threading.enumerate())
    seen = collections.Counter()
    client_batch.drive_chunks(
        {"x": torch.zeros(2)}, [(0, 2), (2, 3)], lambda n: n,
        lambda c, b, c0, c1: ({"x": c["x"] + b}, b),
        lambda c, c0, c1, out, h, d, w: seen.update([(c0, c1, out)]))
    assert seen == {(0, 2, 2): 1, (2, 3, 1): 1}
