"""The port's client stores (``repro_torch.core.client_store``,
``run_federated`` and the LM driver with ``client_store="host"`` and
``"sharded"``) on the CPU.

* The store contract on both ported backends: ``scatter(ids, gather(ids))``
  is the identity for empty, single, boundary, arbitrary and full id sets,
  a scatter touches the cohort rows only and the next gather sees it,
  ``unstack`` returns the states, an unknown backend is refused; a plan's
  cohort is its sampled set.
* Against the JAX package's host store (``run_cohort``), with the JAX run's
  draws handed to the port and the JAX package's contract (identical
  sampled / participant / dropped / failed / rejected lists and byte
  ledgers, loss within 1e-4, accuracies within 1e-3, states within 5e-4):
  celora, participation 0.5, int8, S^data on, 3 rounds.  (The JAX
  package's host and device stores part with S^data on, so the port's
  host store is held to the JAX host store there, and to the port's
  device store with S^data off.)
* The sharded store (``client_store="sharded"``) on 1, 2 and 4 emulated
  devices: the contract, and its history bitwise the device store's on
  both engines.
* Port against port: host ≡ device on both engines with the codec,
  stragglers and the fault storm; host-store kill and resume on the scan
  engine, bitwise; a checkpoint of the other store refused; the LM
  driver's host path against its device path, and its CLI.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcompress
from repro.core import federated as jfed
from repro.core import sampling as jsampling
from repro.core.fed_model import FedTask as JFedTask
from repro.data import synthetic as jsynthetic
from repro.models.config import ModelConfig as JConfig
from repro_torch import checkpoint, convert
from repro_torch.core import client_store, federated, sampling
from repro_torch.launch import mesh, train
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
M, CLASSES = 4, 2
FED = dict(n_clients=M, local_steps=2, batch_size=8, lr=1e-2, seed=14,
           feature_samples=24, cka_probes=16, gmm_iters=10, chunk_rounds=2)
JAX_HOST = dict(FED, method="celora", participation=0.5, uplink_codec="int8",
                rounds=3, client_store="host")
STORM = dict(fault_crash=0.15, fault_loss=0.2, fault_corrupt=0.25,
             fault_divergent=0.15, admission="norm")
STORES = ("device", "host", "sharded")


# ---------------------------------------------------------------------------
# the store contract
# ---------------------------------------------------------------------------

_M = 6
_ID_CASES = {"empty": [], "single": [3], "pair": [0, _M - 1],
             "subset": [1, 2, 4], "full": list(range(_M))}


def _toy_states(m=_M, seed=0):
    """m small per-client trees of mixed shapes, ranks and dtypes."""
    rng = np.random.default_rng(seed)
    return [{"A": torch.from_numpy(rng.standard_normal((3, 2), np.float32)),
             "C": torch.from_numpy(rng.standard_normal((2, 2), np.float32)),
             "ef": {"C": torch.from_numpy(
                 rng.standard_normal((2, 2), np.float32))},
             "h": torch.from_numpy(rng.standard_normal(4, np.float32)).to(
                 torch.bfloat16),
             "step": torch.tensor(i, dtype=torch.int32)}
            for i in range(m)]


def _snapshot(store):
    pop = (store.population if store.backend == "host"
           else store.resident())
    return tree_map(lambda t: t.clone(), pop)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("case", sorted(_ID_CASES))
@pytest.mark.parametrize("backend", STORES)
def test_gather_scatter_roundtrip(backend, case):
    store = client_store.make_store(backend, _toy_states(), device="cpu")
    ids = np.asarray(_ID_CASES[case], np.int64)
    before = _snapshot(store)
    rows = store.gather(ids)
    assert all(t.shape[0] == len(ids) for t in tree_leaves(rows))
    store.scatter(ids, rows)
    assert _equal(before, _snapshot(store))


@pytest.mark.parametrize("backend", STORES)
def test_scatter_touches_only_cohort_rows(backend):
    store = client_store.make_store(backend, _toy_states(), device="cpu")
    ids = np.asarray([1, 4])
    before = _snapshot(store)
    store.scatter(ids, tree_map(lambda t: t + 1, store.gather(ids)))
    after = _snapshot(store)
    sel = torch.zeros(_M, dtype=torch.bool)
    sel[ids] = True
    for b, a in zip(tree_leaves(before), tree_leaves(after)):
        assert torch.equal(a[~sel], b[~sel])
        assert torch.equal(a[sel], (b[sel] + 1).to(a.dtype))
    # the next gather sees the written rows
    assert _equal(store.gather(ids), tree_map(lambda t: t[ids], after))


@pytest.mark.parametrize("backend", STORES)
def test_unstack_matches_states(backend):
    states = _toy_states()
    out = client_store.make_store(backend, states, device="cpu").unstack()
    assert len(out) == _M
    assert all(_equal(s, o) for s, o in zip(states, out))


def test_unknown_and_sharded_backends():
    """An unknown backend is refused; the sharded store and the device
    store's ``shard`` placement (they raised until the mesh layer was
    ported) hold the device store's stack, on a one-device mesh of the
    CPU run's device."""
    with pytest.raises(ValueError, match="client_store"):
        client_store.make_store("disk", _toy_states())
    want = client_store.make_store("device", _toy_states()).resident()
    for backend, kw in (("sharded", {}), ("device", {"parallelism": "shard"})):
        store = client_store.make_store(backend, _toy_states(), **kw)
        assert store.mesh.shape == {"clients": 1}
        assert _equal(store.resident(), want)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_client_mesh(_M)        # no CPU mesh by default


# ---------------------------------------------------------------------------
# the sharded store at emulated mesh sizes
# ---------------------------------------------------------------------------

_MD = 8                                  # divisible by every d below
#: id sets within one block, across block boundaries, and all rows
_MD_CASES = {"empty": [], "single": [3], "pair": [0, _MD - 1],
             "subset": [1, 2, 4, 6], "full": list(range(_MD))}


@pytest.mark.parametrize("case", sorted(_MD_CASES))
@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_store_contract(d, case):
    """On d emulated devices (``[cpu] * d``): d blocks of m/d rows, gather
    bitwise the device store's, ``scatter(ids, gather(ids))`` the identity,
    a scatter of changed rows touching those rows only, as the device
    store's does."""
    devices = [torch.device("cpu")] * d
    store = client_store.make_store("sharded", _toy_states(_MD),
                                    devices=devices)
    ref = client_store.make_store("device", _toy_states(_MD))
    assert store.mesh.size == d and len(store._blocks) == d
    assert all(t.shape[0] == _MD // d for b in store._blocks
               for t in tree_leaves(b))
    ids = np.asarray(_MD_CASES[case], np.int64)
    before = _snapshot(store)
    assert _equal(store.gather(ids), ref.gather(ids))
    store.scatter(ids, store.gather(ids))
    assert _equal(before, _snapshot(store))
    rows = tree_map(lambda t: t + 1, store.gather(ids))
    store.scatter(ids, rows)
    ref.scatter(ids, rows)
    assert _equal(_snapshot(store), ref.resident())
    assert _equal(store.gather(ids), rows)


def test_host_store_copies_and_stays_on_the_host():
    """The host store's rows are its own (the caller's states are never
    written) and live on the host; a gather is a copy."""
    states = _toy_states()
    store = client_store.make_store("host", states, device="cpu")
    rows = store.gather([2])
    rows["A"].add_(5.0)
    store.scatter([2], tree_map(lambda t: t * 0, rows))
    assert torch.equal(store.population["A"][2], torch.zeros(3, 2))
    assert torch.equal(states[2]["A"], _toy_states()[2]["A"])
    assert all(t.device.type == "cpu" for t in tree_leaves(store.population))


def test_plan_cohort_is_sampled():
    """A plan's cohort is its SAMPLED set (stragglers train) and
    cohort_mask is mask(m) over it, as in the JAX package."""
    args = dict(sampler="uniform", m=10, participation=0.6,
                straggler_frac=0.4, rnd=3, seed=7)
    plan, ref = sampling.build_plan(**args), jsampling.build_plan(**args)
    np.testing.assert_array_equal(plan.cohort, plan.sampled)
    assert plan.dropped.size > 0
    np.testing.assert_array_equal(plan.cohort_mask(),
                                  plan.mask(10)[plan.sampled])
    np.testing.assert_array_equal(plan.cohort_mask(), ref.cohort_mask())
    np.testing.assert_array_equal(plan.cohort, ref.cohort)


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    ctrain, ctest, _ = jsynthetic.make_federated_classification(
        0, M, 40, 12, 16, TINY["vocab_size"], CLASSES, drift=0.8)
    jcfg = JConfig(**TINY)
    base = jax.jit(lambda k: JFedTask.create(k, jcfg, CLASSES).base)(
        jax.random.key(0))
    jtask = JFedTask(jcfg, base, CLASSES)
    task = convert.fed_task_from_numpy(ModelConfig(**TINY),
                                       jax.tree.map(np.asarray, base),
                                       CLASSES, "cpu")
    return {"jtask": jtask, "task": task, "ctrain": ctrain, "ctest": ctest}


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


def _assert_contract(ref_hist, out_hist, ref_states, out_states):
    """The JAX package's engine contract."""
    assert len(ref_hist) == len(out_hist)
    for a, b in zip(ref_hist, out_hist):
        assert [getattr(a, k) for k in LEDGER] == \
            [getattr(b, k) for k in LEDGER]
        assert abs(a.train_loss - b.train_loss) < 1e-4, a.round
        np.testing.assert_allclose(a.accs, b.accs, atol=1e-3)
    for s_ref, s_out in zip(ref_states, out_states, strict=True):
        want, got = _paths(tree_map(_np, s_ref)), _paths(s_out)
        assert want.keys() == got.keys()
        for k, v in want.items():
            np.testing.assert_allclose(_np(got[k]), v, atol=5e-4,
                                       err_msg=k)


def test_host_matches_jax_host_store(setup):
    ref = jfed.run_federated(setup["jtask"], jfed.FedConfig(**JAX_HOST),
                             setup["ctrain"], setup["ctest"])
    out = _port(setup, JAX_HOST, _draws(setup, JAX_HOST))
    _assert_contract(ref["history"], out["history"],
                     [jax.tree.map(np.asarray, s) for s in ref["states"]],
                     out["states"])
    assert all(t.device.type == "cpu" for s in out["states"]
               for t in tree_leaves(s))
    assert all(r.host_s >= 0.0 and r.device_s > 0.0 for r in out["history"])


HOST_CASES = {
    "eager-int8": dict(method="celora", participation=0.5,
                       uplink_codec="int8"),
    "scan-int8": dict(method="celora", participation=0.5,
                      uplink_codec="int8", engine="scan"),
    "eager-storm": dict(method="celora", participation=0.5,
                        uplink_codec="int8", **STORM),
    "scan-pfedme-stragglers": dict(method="pfedme_lora", straggler_frac=0.3,
                                   engine="scan", seed=1),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_matches_device(setup, case):
    """S^data off: the host store's history is the device store's."""
    kw = dict(FED, rounds=3, use_data_sim=False, **HOST_CASES[case])
    ref = _port(setup, kw)
    out = _port(setup, kw, client_store="host")
    _assert_contract(ref["history"], out["history"], ref["states"],
                     out["states"])
    if case == "eager-storm":
        assert any(r.failed for r in out["history"])
        assert any(r.rejected for r in out["history"])
    if kw["method"] == "celora":
        # what stays on the device between rounds: the C bank (+ its EF
        # residual) and S^model, far below the population
        pop = sum(t.numel() * t.element_size() for s in ref["states"]
                  for t in tree_leaves(s))
        assert 0 < out["device_resident_bytes"] < pop / 4


def _assert_bitwise(a, b):
    times = ("wall_s", "host_s", "device_s")
    for ra, rb in zip(a["history"], b["history"], strict=True):
        assert ({k: v for k, v in vars(ra).items() if k not in times}
                == {k: v for k, v in vars(rb).items() if k not in times})
    for sa, sb in zip(a["states"], b["states"], strict=True):
        la, lb = _paths(sa), _paths(sb)
        assert la.keys() == lb.keys()
        assert all(torch.equal(la[k], lb[k]) for k in la)


SHARDED = dict(FED, rounds=3, method="celora", participation=0.5,
               uplink_codec="int8")


@pytest.fixture(scope="module")
def device_runs(setup):
    """The device store's runs that the sharded store is held to."""
    return {engine: _port(setup, SHARDED, engine=engine)
            for engine in ("eager", "scan")}


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_sharded_matches_device(setup, device_runs, monkeypatch, engine, d):
    """``client_store="sharded"`` over d emulated devices (the CPU run's
    device d times): bitwise the device store's run, history and states,
    on both engines."""
    monkeypatch.setattr(mesh, "run_devices",
                        lambda dev: [torch.device(dev)] * d)
    out = _port(setup, SHARDED, engine=engine, client_store="sharded")
    _assert_bitwise(out, device_runs[engine])


RESUME = dict(FED, method="celora", participation=0.5, uplink_codec="int8",
              use_data_sim=False, engine="scan", client_store="host",
              local_steps=1, **STORM)


@pytest.mark.parametrize("prefetch", [True, False])
def test_host_kill_and_resume_is_bitwise(setup, tmp_path, prefetch):
    """Killed at 2 rounds and resumed to 4 (the EF residuals, the
    admission ring and the accept rows cross the checkpoint): bitwise the
    uninterrupted run."""
    path = str(tmp_path / "host.npz")
    kw = dict(RESUME, scan_prefetch=prefetch)
    full = _port(setup, kw, rounds=4)
    _port(setup, kw, rounds=2, checkpoint_path=path)
    assert checkpoint.metadata(path)["client_store"] == "host"
    resumed = _port(setup, kw, rounds=4, checkpoint_path=path, resume=True)
    _assert_bitwise(full, resumed)
    assert os.listdir(tmp_path) == ["host.npz"]


@pytest.mark.parametrize("written,resumed", [("device", "host"),
                                             ("host", "device")])
def test_checkpoint_of_the_other_store_is_rejected(setup, tmp_path, written,
                                                   resumed):
    path = str(tmp_path / "fed.npz")
    kw = dict(RESUME, rounds=2, local_steps=1)
    _port(setup, kw, client_store=written, checkpoint_path=path)
    with pytest.raises(ValueError, match="different run configuration"):
        _port(setup, kw, rounds=4, client_store=resumed,
              checkpoint_path=path, resume=True)


# ---------------------------------------------------------------------------
# the LM driver
# ---------------------------------------------------------------------------

LM = dict(arch="fed-100m", reduced=True, rounds=2, local_steps=2, batch=2,
          seq=16, lr=3e-3, seed=5, clients=3, participation=0.67,
          verbose=False, device="cpu")


@pytest.mark.parametrize("method,codec", [("celora", "int8"),
                                          ("fedavg", "int8"),
                                          ("celora", "none")])
def test_lm_driver_host_matches_device(method, codec):
    ref = train.run(**LM, method=method, uplink_codec=codec)
    out = train.run(**LM, method=method, uplink_codec=codec,
                    client_store="host")
    for a, b in zip(ref["history"], out["history"], strict=True):
        for key in ("round", "participants", "uplink_bytes",
                    "downlink_bytes", "uplink_floats"):
            assert a[key] == b[key], key
        assert abs(a["loss"] - b["loss"]) < 1e-4
    for x, y in zip(ref["adapters"], out["adapters"], strict=True):
        px, py = _paths(x), _paths(y)
        assert px.keys() == py.keys()
        for k in px:
            assert py[k].device.type == "cpu"
            np.testing.assert_allclose(_np(py[k]), _np(px[k]), atol=5e-5,
                                       err_msg=k)


def test_lm_cli_host_store(capsys, tmp_path):
    path = str(tmp_path / "lm.npz")
    out = train.main(["--arch", "fed-100m", "--reduced", "--clients", "3",
                      "--rounds", "2", "--local-steps", "1", "--batch", "2",
                      "--seq", "16", "--participation", "0.67",
                      "--client-store", "host", "--ckpt", path,
                      "--device", "cpu"])
    assert [len(r["participants"]) for r in out["history"]] == [2, 2]
    assert "over 2 rounds" in capsys.readouterr().out
    checkpoint.verify(path)
    with pytest.raises(ValueError, match="host"):
        train.run(**LM, engine="scan", client_store="host")
