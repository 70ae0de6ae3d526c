"""The port's asynchronous buffered engine (``repro_torch.core.async_engine``,
``run_federated`` and the LM driver with ``engine="async"``) on the CPU.

* ``LatencyModel`` draws the JAX package's numpy streams bit for bit, and
  the port's ``AsyncScheduler`` replays the JAX scheduler's event sequence
  exactly under stub fit and flush callbacks (lognormal latency, K < k,
  concurrency past the cohort, a retry storm) — pure host code.
* Against the JAX package's ``run_async``, with the JAX runs' own draws
  handed to the port and the JAX package's contract (identical sampled /
  participant / failed / rejected lists, ``evaluated`` flags and byte
  ledgers, loss within 1e-4, accuracies within 1e-3, states within 5e-4):
  a storm (celora, int8, participation 0.5, lognormal σ 1, K = 1,
  concurrency 3, staleness decay 0.7, crashes, lost and NaN-corrupted
  uploads, the norm gate, a dispatch timeout and retry cap 1: uploads are
  rejected, retried and dropped for good), the same storm killed after 2
  flushes and its JAX checkpoint resumed in the port (held to the JAX
  package's resume of it); the three share their compiled programs.  The
  staleness discount of eqn (3) and of FedAvg against the JAX forms.
* Port against port: the zero-staleness limit (uniform latency, K = k)
  against the eager vmap path, kill and resume bitwise, the validation
  errors of the JAX package's tests/test_async_engine.py, and the LM
  driver's async path at the zero-staleness limit against its eager vmap
  path.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jaggregation
from repro.core import async_engine as jasync
from repro.core import compress as jcompress
from repro.core import faults as jfaults
from repro.core import federated as jfed
from repro.core import sampling as jsampling
from repro.core.fed_model import FedTask as JFedTask
from repro.data import synthetic as jsynthetic
from repro.models.config import ModelConfig as JConfig
from repro_torch import checkpoint, convert
from repro_torch.core import (aggregation, async_engine, faults, federated,
                              sampling)
from repro_torch.core.baselines import get_strategy
from repro_torch.launch import train
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
M, CLASSES = 4, 2
FED = dict(n_clients=M, local_steps=1, batch_size=8, lr=1e-2,
           feature_samples=24, cka_probes=16, gmm_iters=10,
           use_data_sim=False, engine="async", chunk_rounds=1)
STORM = dict(FED, method="celora", participation=0.5, uplink_codec="int8",
             rounds=4, seed=11, latency="lognormal", latency_sigma=1.0,
             staleness_decay=0.7, buffer_size=1, async_concurrency=3,
             dispatch_timeout=3.0, retry_backoff=0.5, retry_cap=1,
             fault_crash=0.15, fault_loss=0.25, fault_corrupt=0.25,
             admission="norm")
JAX_RUNS = {
    "storm": STORM,
    "killed": dict(STORM, rounds=2),
    "resumed": dict(STORM, resume=True),
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
            "dir": tmp_path_factory.mktemp("async"), "memo": {}}


def _jax_run(setup, name):
    memo = setup["memo"]
    if name not in memo:
        kw = dict(JAX_RUNS[name])
        if name == "resumed":
            _jax_run(setup, "killed")
            shutil.copy(setup["dir"] / "jax_killed.npz",
                        setup["dir"] / "jax_resumed.npz")
        if name in ("killed", "resumed"):
            kw["checkpoint_path"] = str(setup["dir"] / f"jax_{name}.npz")
        memo[name] = jfed.run_federated(setup["jtask"], jfed.FedConfig(**kw),
                                        setup["ctrain"], setup["ctest"])
    return memo[name]


def _draws(setup, kw):
    """The JAX runtime's draws for config ``kw``: client init, CKA probes
    and the codec's uniforms per (wave, client)."""
    jtask, seed = setup["jtask"], kw["seed"]
    ckeys = jax.random.split(jax.random.key(seed), M)
    clients = [convert.params_from_numpy(jax.tree.map(
        np.asarray, jtask.init_client(ckeys[i])), "cpu") for i in range(M)]
    probes = torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(seed + 97), (kw["cka_probes"], TINY["lora_rank"]),
        jnp.float32)))
    out = dict(init_clients=clients, cka_probes=probes)
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
    """The JAX package's engine contract."""
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
    """Two port runs: every history field but the wall time, the virtual
    clock, and every state leaf, bit for bit."""
    for ra, rb in zip(a["history"], b["history"], strict=True):
        fa = {k: v for k, v in vars(ra).items() if k != "wall_s"}
        fb = {k: v for k, v in vars(rb).items() if k != "wall_s"}
        assert fa == fb
    assert a["sim_times"] == b["sim_times"]
    assert a["staleness_mean"] == b["staleness_mean"]
    for sa, sb in zip(a["states"], b["states"], strict=True):
        la, lb = _paths(sa), _paths(sb)
        assert la.keys() == lb.keys()
        assert all(torch.equal(la[k], lb[k]) for k in la)


# ---------------------------------------------------------------------------
# the latency model and the scheduler: pure host code
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sampling.LATENCIES)
def test_latency_model_matches_jax_bitwise(kind):
    assert sampling.LATENCIES == jsampling.LATENCIES
    ours = sampling.LatencyModel(kind, scale=1.7, sigma=0.9)
    ref = jsampling.LatencyModel(kind, scale=1.7, sigma=0.9)
    for wave, seed in ((0, 0), (3, 7), (11, 123)):
        a, b = ours.draw(9, wave, seed), ref.draw(9, wave, seed)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
        for client, attempt in ((0, 1), (5, 2), (8, 3)):
            assert ours.draw_retry(wave, client, attempt, seed) == \
                ref.draw_retry(wave, client, attempt, seed)
    for bad in (dict(kind="gaussian"), dict(kind=kind, scale=0.0)):
        with pytest.raises(ValueError):
            sampling.LatencyModel(**bad)


SCHEDULES = {
    "uniform": dict(latency=("uniform", 1.0, 0.5), k_buf=4, conc=4),
    "lognormal": dict(latency=("lognormal", 1.0, 1.0), k_buf=2, conc=7),
    "storm": dict(latency=("lognormal", 2.0, 1.0), k_buf=3, conc=6,
                  timeout=3.0, backoff=0.5, retry_cap=2,
                  faults=dict(crash=0.2, loss=0.25)),
}


def _events(mod, fm_mod, sched_kw: dict, waves: list, m: int,
            seed: int) -> list:
    """The event sequence of ``mod``'s AsyncScheduler under stub callbacks:
    each fit group's (seq, client, wave, attempt) rows, each flush's index
    and sim time then (seq, client, wave, staleness) per record, and the
    drops."""
    events = []

    def fit_group(records):
        events.append(("fit", [(r.seq, r.client, r.wave, r.attempt)
                               for r in records]))
        for r in records:
            r.loss, r.upload = 0.0, None

    def flush_cb(records, f, sim_now):
        events.append(("flush", f, sim_now,
                       [(r.seq, r.client, r.wave, f - r.version, r.tx)
                        for r in records]))

    fail_of = None
    if "faults" in sched_kw:
        fm = fm_mod.FaultModel(**sched_kw["faults"])

        def fail_of(w, c, a):
            return fm.draw_one(w, c, seed, a)[:2]
    sampling_mod = jsampling if mod is jasync else sampling
    sched = mod.AsyncScheduler(
        waves=waves, m=m,
        latency=sampling_mod.LatencyModel(*sched_kw["latency"]), seed=seed,
        buffer_size=sched_kw["k_buf"], concurrency=sched_kw["conc"],
        rounds=len(waves), fit_group=fit_group, flush_cb=flush_cb,
        timeout=sched_kw.get("timeout", 0.0),
        backoff=sched_kw.get("backoff", 1.0),
        retry_cap=sched_kw.get("retry_cap", 3), fail_of=fail_of,
        on_drop=lambda rec: events.append(("drop", rec.seq, rec.client)))
    sched.run()
    return events + [("end", sched.version, sched.n_dropped, sched.next_seq)]


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_scheduler_replays_the_jax_event_sequence(name):
    m, seed = 10, 3
    waves = [np.sort(np.random.default_rng((seed, w)).choice(
        m, 5, replace=False)) for w in range(12)]
    kw = SCHEDULES[name]
    ours = _events(async_engine, faults, kw, waves, m, seed)
    ref = _events(jasync, jfaults, kw, waves, m, seed)
    assert ours == ref
    flushes = [e for e in ours if e[0] == "flush"]
    assert len(flushes) == len(waves)
    if name != "uniform":
        assert any(st > 0 for e in flushes for (_, _, _, st, _) in e[3])
        assert any(len(e[1]) < kw["conc"] for e in ours if e[0] == "fit")
    if name == "storm":
        assert any(e[0] == "drop" for e in ours)
        assert any(tx > 1 for e in flushes for (*_, tx) in e[3])


# ---------------------------------------------------------------------------
# against the JAX package's async engine
# ---------------------------------------------------------------------------

def test_async_matches_jax_async(setup):
    ref = _jax_run(setup, "storm")
    out = _port(setup, STORM, _draws(setup, STORM))
    hist = ref["history"]
    assert any(r.rejected for r in hist) and any(r.failed for r in hist)
    assert max(ref["staleness_mean"]) > 0
    _assert_contract(ref["history"], out["history"], ref["states"],
                     out["states"])
    assert out["sim_times"] == ref["sim_times"]
    assert out["staleness_mean"] == ref["staleness_mean"]


def test_port_resumes_the_jax_async_checkpoint(setup, tmp_path):
    """The JAX package's flush-boundary checkpoint of the killed storm (in
    flight: pending records with their encoded uploads and EF snapshots,
    the admission ring, the attempt counters) resumes in the port as it
    resumes in the JAX package.  The killed run's dispatch stream held 2
    waves, so in both packages the resumed run is not the uninterrupted
    one (a later arrival, other accuracies): it is held to the JAX
    package's own resume."""
    killed = _jax_run(setup, "killed")
    resumed = _jax_run(setup, "resumed")
    path = tmp_path / "resumed.npz"
    shutil.copy(setup["dir"] / "jax_killed.npz", path)
    meta = checkpoint.metadata(str(path))
    assert meta["engine"] == "async" and meta["rounds_done"] == 2
    assert meta["n_pending"] > 0
    out = _port(setup, STORM, _draws(setup, STORM),
                checkpoint_path=str(path), resume=True)
    for a, b in zip(killed["history"], out["history"][:2]):
        assert (a.train_loss, a.accs) == (b.train_loss, b.accs)
    _assert_contract(resumed["history"], out["history"], resumed["states"],
                     out["states"])
    assert out["sim_times"] == resumed["sim_times"]
    assert checkpoint.metadata(str(path))["rounds_done"] == 4


def test_staleness_discount_matches_jax():
    """The staleness ``col_scale`` of eqn (3) and of FedAvg against the
    JAX package's, and ``col_scale=None`` bit for bit the plain forms."""
    rng = np.random.default_rng(3)
    m = 6
    sim = rng.standard_normal((m, m)).astype(np.float32)
    sim = sim + sim.T
    part = np.array([1, 0, 1, 1, 0, 1], bool)
    col = np.where(part, 0.5 ** rng.integers(0, 3, m), 1.0).astype(
        np.float32)
    payload = {"C": rng.standard_normal((m, 2, 4, 4)).astype(np.float32)}
    counts = [5, 9, 2, 7, 4, 6]
    t = {k: torch.from_numpy(v) for k, v in payload.items()}
    for c in (col, None):
        tc = None if c is None else torch.from_numpy(c)
        w = aggregation.personalized_weights(
            torch.from_numpy(sim), 0.1, torch.from_numpy(part), col_scale=tc)
        np.testing.assert_allclose(w.numpy(), np.asarray(
            jaggregation.personalized_weights(sim, 0.1, part, col_scale=c)),
            rtol=1e-6, atol=1e-7)
        g = aggregation.fedavg_stacked(t, counts, torch.from_numpy(part),
                                       col_scale=tc)
        np.testing.assert_allclose(g["C"].numpy(), np.asarray(
            jaggregation.fedavg_stacked(payload, counts, part,
                                        col_scale=c)["C"]),
            rtol=1e-6, atol=1e-6)
    assert torch.equal(
        aggregation.personalized_weights(torch.from_numpy(sim), 0.1,
                                         torch.from_numpy(part)),
        aggregation.personalized_weights(torch.from_numpy(sim), 0.1,
                                         torch.from_numpy(part),
                                         col_scale=None))
    down = get_strategy("fedpetuning").server_stacked(
        t, sample_counts=counts, participants=torch.from_numpy(part),
        col_scale=torch.from_numpy(col))
    assert torch.equal(down["C"][0], down["C"][5])


def test_fingerprint_matches_jax():
    fed = dict(STORM, attn_impl=None)
    assert async_engine.async_fingerprint(
        federated.FedConfig(**fed), 1, 3) == jasync.async_fingerprint(
            jfed.FedConfig(**fed), 1, 3)


# ---------------------------------------------------------------------------
# port against port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,codec,participation", [
    ("celora", "int8", 1.0), ("celora", "none", 0.5),
    ("celora_fedavg", "none", 0.5)])
def test_zero_staleness_limit_is_the_eager_vmap_path(setup, method, codec,
                                                     participation):
    """Uniform latency with K = cohort size: every flush is one sync round
    (with a codec only at full participation, as in the JAX package)."""
    kw = dict(FED, method=method, uplink_codec=codec, rounds=3, seed=2,
              participation=participation, local_steps=2)
    eager = _port(setup, kw, engine="eager")
    out = _port(setup, kw)
    _assert_contract(eager["history"], out["history"],
                     [jax.tree.map(_np, s) for s in eager["states"]],
                     out["states"])
    assert out["staleness_mean"] == [0.0] * 3


class _Killed(Exception):
    pass


def test_kill_and_resume_is_bitwise(setup, tmp_path, monkeypatch):
    """The storm killed right after its flush-2 checkpoint (the same run,
    so the same dispatch stream) and resumed: bitwise the uninterrupted
    run, virtual clock included."""
    path = str(tmp_path / "async.npz")
    full = _port(setup, STORM)
    save = async_engine._save_async

    def save_then_die(fed, sched, *args, **kw):
        save(fed, sched, *args, **kw)
        if sched.version == 2:
            raise _Killed
    monkeypatch.setattr(async_engine, "_save_async", save_then_die)
    with pytest.raises(_Killed):
        _port(setup, STORM, checkpoint_path=path)
    monkeypatch.undo()
    assert checkpoint.metadata(path)["n_pending"] > 0
    resumed = _port(setup, STORM, checkpoint_path=path, resume=True)
    _assert_bitwise(full, resumed)
    assert any(r.failed for r in full["history"])
    with pytest.raises(ValueError, match="different run configuration"):
        _port(setup, STORM, checkpoint_path=path, resume=True,
              latency_scale=2.0)


@pytest.mark.parametrize("override,match", [
    (dict(buffer_size=99), "buffer_size"),
    (dict(straggler_frac=0.3), "straggler"),
    (dict(client_parallelism="loop"), "vectorized"),
    (dict(latency="gaussian"), "latency"),
    (dict(staleness_decay=0.0), "staleness_decay"),
    (dict(client_store="host"), "client_store"),
    (dict(engine="scan", dispatch_timeout=4.0), "dispatch_timeout"),
    (dict(engine="eager", client_store="host", client_parallelism="loop"),
     "client_store"),
])
def test_async_config_validation(setup, override, match):
    kw = dict(FED, method="celora", rounds=1, seed=0)
    with pytest.raises(ValueError, match=match):
        _port(setup, kw, **override)


def test_fit_groups_of_one_go_through_the_stacked_fit(setup):
    """K = 1 with lognormal arrivals: clients dispatch one at a time after
    the first wave, each group the vectorized fit of one client."""
    out = _port(setup, dict(FED, method="celora", participation=0.5,
                            rounds=3, seed=3, latency="lognormal",
                            buffer_size=1, staleness_decay=0.5))
    assert 1 in out["fit_groups"] and sum(out["fit_groups"]) >= 3
    assert all(np.isfinite(r.train_loss) for r in out["history"])


# ---------------------------------------------------------------------------
# the LM driver
# ---------------------------------------------------------------------------

LM = dict(arch="fed-100m", reduced=True, rounds=2, local_steps=2, batch=2,
          seq=16, lr=3e-3, seed=5, clients=3, verbose=False, device="cpu")


@pytest.mark.parametrize("method,codec,participation", [
    ("celora", "int8", 1.0), ("fedavg", "none", 0.67)])
def test_lm_async_zero_staleness_is_the_eager_vmap_path(method, codec,
                                                        participation):
    kw = dict(LM, method=method, uplink_codec=codec,
              participation=participation)
    eager = train.run(**kw)
    out = train.run(**kw, engine="async")
    for a, b in zip(eager["history"], out["history"], strict=True):
        for key in ("round", "participants", "uplink_bytes",
                    "downlink_bytes", "uplink_floats"):
            assert a[key] == b[key], key
        assert abs(a["loss"] - b["loss"]) < 1e-4
        assert b["staleness"] == 0.0
    for x, y in zip(eager["adapters"], out["adapters"]):
        px, py = _paths(x), _paths(y)
        assert px.keys() == py.keys()
        for k in px:
            np.testing.assert_allclose(_np(py[k]), _np(px[k]), atol=5e-4,
                                       err_msg=k)


def test_lm_async_staleness_and_cli(capsys):
    out = train.main(["--arch", "fed-100m", "--reduced", "--clients", "3",
                      "--rounds", "3", "--local-steps", "1", "--batch", "2",
                      "--seq", "16", "--engine", "async", "--latency",
                      "lognormal", "--latency-sigma", "1.0",
                      "--buffer-size", "1", "--staleness-decay", "0.5",
                      "--device", "cpu"])
    hist = out["history"]
    assert len(hist) == 3 and all(len(r["participants"]) == 1 for r in hist)
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert "over 3 rounds" in capsys.readouterr().out
    with pytest.raises(ValueError, match="resume"):
        train.run(**LM, engine="async", resume=True)
    with pytest.raises(ValueError, match="client_store"):
        train.run(**LM, engine="async", client_store="host")
