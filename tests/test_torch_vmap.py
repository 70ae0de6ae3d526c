"""The port's vectorized clients (``client_parallelism="vmap"``) against the
JAX package's ``jax.vmap`` paths and against the port's own loop path, on
the CPU.

* The grouped tri-LoRA projection's plain versions (``kernels/tri_lora/
  ref.py``, the CPU side of the grouped kernels) and the plain grouped
  ``layers.dense`` against ``jax.vmap`` of the JAX ``dense`` and against
  its grouped ``dense``, forward and VJP, at the kernel tolerance 2e-5.
* A stacked loss gives each client exactly its own gradient.
* ``run_federated`` and the LM driver with ``"vmap"`` against the JAX
  package's ``"vmap"`` runs (the JAX draws handed to the port) and against
  the port's ``"loop"`` runs, at ROADMAP's history tolerances: identical
  ledgers, loss within 1e-4, accuracies within 1e-3, states within 5e-4.
  ``"shard"`` (on the device and the sharded store) against the same JAX
  vmap runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcompress
from repro.core import federated as jfed
from repro.core import tri_lora as jtri_lora
from repro.core.baselines import STRATEGIES
from repro.core.fed_model import FedTask as JFedTask
from repro.data import synthetic as jsynthetic
from repro.launch import train as jtrain
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JConfig
from repro.models.config import get_config as jget_config
from repro_torch import convert
from repro_torch.core import federated
from repro_torch.core.fed_model import FedTask
from repro_torch.kernels.tri_lora import ref
from repro_torch.launch import train
from repro_torch.models import layers, model
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
M, CLASSES = 4, 2
FED = dict(n_clients=M, rounds=2, local_steps=2, batch_size=8, lr=1e-2,
           seed=3, feature_samples=24, cka_probes=16, gmm_iters=10)
#: the JAX vmap runs the port is held to: CE-LoRA under partial
#: participation with the int8 codec, and FDLoRA's dual adapters
JAX_RUNS = {"celora": dict(participation=0.5, uplink_codec="int8"),
            "fdlora": dict()}
TOL = 2e-5


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


def _assert_trees_close(want, got, atol: float) -> None:
    wp, gp = _paths(want), _paths(got)
    assert wp.keys() == gp.keys()
    for k, v in wp.items():
        g = gp[k]
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        w = v.detach().float().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v, np.float32)
        np.testing.assert_allclose(g, w, atol=atol, err_msg=k)


def _uniforms(seed: int, codec_name: str, like):
    """(round, client) → the uniforms the JAX codec draws from
    ``client_key(seed, round, client)`` for a payload shaped like ``like``,
    one (n_tiles, tile) tensor per leaf in the JAX package's order."""
    codec = jcompress.get_codec(codec_name)
    sizes = [int(np.prod(np.shape(l))) for l in jax.tree.leaves(like)]

    def draw(rnd: int, i: int) -> list:
        keys = jax.random.split(jcompress.client_key(seed, rnd, i),
                                len(sizes))
        return [torch.from_numpy(np.array(jax.random.uniform(
            k, (-(-n // jcompress._leaf_tile(n, codec.pack)),
                jcompress._leaf_tile(n, codec.pack)))))
            for n, k in zip(sizes, keys)]
    return draw


# ---------------------------------------------------------------------------
# the grouped projection
# ---------------------------------------------------------------------------

def _grouped_inputs(seed, m, b, s, k, n, r):
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return (rn(m, b, s, k), rn(k, n, scale=0.05), rn(m, k, r, scale=0.2),
            rn(m, r, r, scale=0.2), rn(m, r, n, scale=0.2), rn(m, b, s, n))


def test_grouped_ref_matches_jax_vmap_of_dense():
    """One adapter per client, the client's B·S rows sharing it: the plain
    grouped forward and backward against jax.vmap of the JAX dense."""
    m, b, s, k, n, r, sc = 3, 2, 5, 24, 40, 4, 2.0
    x, w, a, c, bb, ct = _grouped_inputs(0, m, b, s, k, n, r)

    def f(x, w, a, c, bb):
        return jax.vmap(lambda xi, ai, ci, bi: jlayers.dense(
            xi, w, adapter={"A": ai, "C": ci, "B": bi},
            lora_scaling=sc))(x, a, c, bb)
    y_j, vjp = jax.vjp(f, x, w, a, c, bb)
    grads_j = vjp(ct)
    t = [torch.from_numpy(v) for v in (x, w, a, c, bb, ct)]
    groups = torch.arange(m, dtype=torch.int32)
    y = ref.grouped_tri_lora_matmul_ref(t[0].reshape(-1, k), t[1], t[2],
                                        t[3], t[4], groups, b * s, sc)
    grads = ref.grouped_tri_lora_bwd_ref(t[0].reshape(-1, k), t[1], t[2],
                                         t[3], t[4], groups,
                                         t[5].reshape(-1, n), b * s, sc)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j).reshape(-1, n),
                               atol=TOL, rtol=TOL)
    for got, want in zip(grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
            got.shape), atol=TOL, rtol=TOL)


def test_grouped_dense_matches_jax_grouped_dense():
    """One adapter per sequence, repeated and masked (-1) indices: the
    plain grouped forward/backward and the port's plain grouped
    ``layers.dense`` against the JAX grouped ``dense``."""
    m, b, s, k, n, r, sc = 3, 2, 5, 24, 40, 4, 2.0
    x, w, a, c, bb, ct = _grouped_inputs(1, m, b, s, k, n, r)
    x, ct = x.reshape(m * b, s, k), ct.reshape(m * b, s, n)
    rows = np.array([2, 0, -1, 1, 0, 2], np.int32)

    def f(x, w, a, c, bb):
        return jlayers.dense(x, w, adapter={"A": a, "C": c, "B": bb},
                             lora_scaling=sc, adapter_rows=jnp.asarray(rows))
    y_j, vjp = jax.vjp(f, x, w, a, c, bb)
    grads_j = vjp(ct)
    t = [torch.from_numpy(v) for v in (x, w, a, c, bb, ct)]
    groups = torch.from_numpy(rows)
    y = ref.grouped_tri_lora_matmul_ref(t[0].reshape(-1, k), t[1], t[2],
                                        t[3], t[4], groups, s, sc)
    grads = ref.grouped_tri_lora_bwd_ref(t[0].reshape(-1, k), t[1], t[2],
                                         t[3], t[4], groups,
                                         t[5].reshape(-1, n), s, sc)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j).reshape(-1, n),
                               atol=TOL, rtol=TOL)
    for got, want in zip(grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
            got.shape), atol=TOL, rtol=TOL)
    leaves = [v.clone().requires_grad_(True) for v in t[:5]]
    y_d = layers.dense(leaves[0], leaves[1], adapter=dict(
        zip("ACB", leaves[2:])), lora_scaling=sc, adapter_rows=groups)
    np.testing.assert_allclose(y_d.detach().numpy(), np.asarray(y_j),
                               atol=TOL, rtol=TOL)
    for got, want in zip(torch.autograd.grad(y_d, leaves, t[5]), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the stacked losses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_task():
    return FedTask.create(torch.Generator().manual_seed(0),
                          ModelConfig(**TINY), CLASSES)


def test_stacked_loss_gives_each_client_its_own_gradient(tiny_task):
    """The stacked FedTask.loss and model.loss_fn return each client's own
    (m,) values, and the gradient of their sum is, client by client, the
    gradient of that client's loss alone (no 1/m from the folded batch)."""
    gen = torch.Generator().manual_seed(1)
    clients = [tiny_task.init_client(gen) for _ in range(3)]
    for c in clients:      # move B off zero so that every factor has a grad
        for a in tree_leaves(c["adapter"]):
            a.add_(0.05 * torch.randn(a.shape, generator=gen))
    stacked = tree_map(lambda *xs: torch.stack(xs), *clients)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, 256, (3, 4, 8)))
    labs = torch.from_numpy(rng.integers(0, CLASSES, (3, 4)))
    leaves = [t.requires_grad_(True) for t in tree_leaves(stacked)]
    nll, acc = tiny_task.loss(stacked, toks, labs)
    grads = torch.autograd.grad(nll.sum(), leaves)
    cfg = tiny_task.cfg
    lm_batch = {"tokens": toks.reshape(12, 8)[:, :-1],
                "labels": toks.reshape(12, 8)[:, 1:]}
    lm_loss, lm_aux = model.loss_fn(
        cfg, stacked["adapter"], tiny_task.base, lm_batch,
        adapter_rows=model.client_rows(3, 4, "cpu"))
    lm_grads = torch.autograd.grad(lm_loss.sum(), tree_leaves(
        stacked["adapter"]))
    for i, c in enumerate(clients):
        ci = tree_map(lambda t: t.detach().clone().requires_grad_(True), c)
        own = tree_leaves(ci)
        nll_i, acc_i = tiny_task.loss(ci, toks[i], labs[i])
        torch.testing.assert_close(nll[i], nll_i)
        torch.testing.assert_close(acc[i], acc_i)
        for g, g_i in zip(grads, torch.autograd.grad(nll_i, own)):
            torch.testing.assert_close(g[i], g_i, atol=1e-6, rtol=1e-5)
        batch_i = {key: v[4 * i:4 * i + 4] for key, v in lm_batch.items()}
        loss_i, aux_i = model.loss_fn(cfg, ci["adapter"], tiny_task.base,
                                      batch_i)
        torch.testing.assert_close(lm_loss[i], loss_i)
        torch.testing.assert_close(lm_aux["acc"][i], aux_i["acc"])
        for g, g_i in zip(lm_grads, torch.autograd.grad(
                loss_i, tree_leaves(ci["adapter"]))):
            torch.testing.assert_close(g[i], g_i, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# run_federated
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
    return jtask, task, ctrain, ctest


def _vmap_kw(method: str) -> dict:
    return dict(FED, method=method, client_parallelism="vmap",
                **JAX_RUNS[method])


@pytest.fixture(scope="module")
def jax_vmap_runs(setup):
    """The JAX package's vmap runs, one compile each."""
    jtask, _, ctrain, ctest = setup
    return {method: jfed.run_federated(jtask, jfed.FedConfig(
        **_vmap_kw(method)), ctrain, ctest) for method in JAX_RUNS}


def _draws(jtask):
    """The JAX runtime's draws: client init, CKA probes, GMM init."""
    ckeys = jax.random.split(jax.random.key(FED["seed"]), M)
    clients = [jax.tree.map(np.asarray, jtask.init_client(ckeys[i]))
               for i in range(M)]
    probes = np.asarray(jax.random.normal(
        jax.random.key(FED["seed"] + 97),
        (FED["cka_probes"], TINY["lora_rank"]), jnp.float32))

    def gmm_init(ci, k, n):
        return np.asarray(jax.random.choice(
            jax.random.key(FED["seed"] + 31 * ci + k), n, (2,),
            replace=False))
    return clients, probes, gmm_init


def _assert_history_close(ref_hist, out_hist):
    assert len(ref_hist) == len(out_hist) == FED["rounds"]
    for a, b in zip(ref_hist, out_hist):
        assert (a.sampled, a.participants, a.dropped) == \
            (b.sampled, b.participants, b.dropped)
        assert (a.uplink_bytes, a.downlink_bytes, a.uplink_elems) == \
            (b.uplink_bytes, b.downlink_bytes, b.uplink_elems)
        assert abs(a.train_loss - b.train_loss) < 1e-4
        np.testing.assert_allclose(a.accs, b.accs, atol=1e-3)


@pytest.mark.parametrize("method", list(JAX_RUNS))
def test_run_federated_vmap_matches_jax_vmap(setup, jax_vmap_runs, method):
    _against_jax_vmap(setup, jax_vmap_runs, method)


@pytest.mark.parametrize("store", ["device", "sharded"])
@pytest.mark.parametrize("method", list(JAX_RUNS))
def test_run_federated_shard_matches_jax_vmap(setup, jax_vmap_runs, method,
                                              store):
    """``client_parallelism="shard"`` (and the sharded store) against the
    JAX vmap run: JAX's shard path is its vmap path on one device (its
    ``test_shard_matches_vmap``), so no JAX shard run is compiled."""
    _against_jax_vmap(setup, jax_vmap_runs, method,
                      client_parallelism="shard", client_store=store)


def _against_jax_vmap(setup, jax_vmap_runs, method, **over):
    jtask, task, ctrain, ctest = setup
    kw = dict(_vmap_kw(method), **over)
    ref_out = jax_vmap_runs[method]
    clients, probes, gmm_init = _draws(jtask)
    extra = {}
    if kw.get("uplink_codec", "none") != "none":
        like = federated.get_strategy(method).uplink(
            convert.params_from_numpy(clients[0], "cpu"))
        extra["sr_uniforms"] = _uniforms(FED["seed"], kw["uplink_codec"],
                                         like)
    out = federated.run_federated(
        task, federated.FedConfig(**kw), ctrain, ctest, device="cpu",
        init_clients=[convert.params_from_numpy(c, "cpu") for c in clients],
        cka_probes=torch.from_numpy(probes), gmm_init=gmm_init, **extra)
    _assert_history_close(ref_out["history"], out["history"])
    for s_ref, s_out in zip(ref_out["states"], out["states"]):
        _assert_trees_close(jax.tree.map(np.asarray, s_ref), s_out, 5e-4)


def _port_run(setup, mode, **kw):
    _, task, ctrain, ctest = setup
    fed = federated.FedConfig(**dict(FED, client_parallelism=mode, **kw))
    return federated.run_federated(task, fed, ctrain, ctest, device="cpu")


@pytest.mark.parametrize("method,kw", [(m, {}) for m in sorted(STRATEGIES)]
                         + [("celora", dict(participation=0.4)),
                            ("pfedme_lora", dict(participation=0.6)),
                            ("fedpetuning", dict(participation=0.5,
                                                 uplink_codec="int4"))])
def test_run_federated_vmap_matches_loop(setup, method, kw):
    loop = _port_run(setup, "loop", method=method, **kw)
    vmap = _port_run(setup, "vmap", method=method, **kw)
    _assert_history_close(loop["history"], vmap["history"])
    assert len(vmap["states"]) == M
    for a, b in zip(loop["states"], vmap["states"]):
        _assert_trees_close(a, b, 5e-4)


def test_defaults_are_the_references():
    """run_federated and the LM driver default to "vmap", as the JAX
    package does; the modes are the JAX package's ("shard" runs since the
    mesh layer was ported: ``test_run_federated_shard_matches_jax_vmap``)
    and an unknown one is refused before anything runs."""
    assert federated.FedConfig().client_parallelism == \
        jfed.FedConfig().client_parallelism == "vmap"
    import inspect
    assert inspect.signature(train.run).parameters[
        "client_parallelism"].default == inspect.signature(
            jtrain.run).parameters["client_parallelism"].default == "vmap"
    assert federated.PARALLELISM_MODES == jfed.PARALLELISM_MODES
    fed = dataclasses.replace(federated.FedConfig(**FED),
                              client_parallelism="pmap")
    with pytest.raises(ValueError, match="client_parallelism"):
        federated.run_federated(None, fed, [None] * M, [], device="cpu")


# ---------------------------------------------------------------------------
# the LM driver
# ---------------------------------------------------------------------------

RUN = dict(arch="fed-100m", reduced=True, rounds=2, local_steps=2, batch=2,
           seq=32, lr=3e-3, seed=5, method="celora", uplink_codec="int8",
           participation=0.5, clients=3)


@pytest.fixture(scope="module")
def jax_lm_vmap_run():
    """The JAX package's LM-driver vmap run (one compile)."""
    return jtrain.run(**RUN, client_parallelism="vmap", verbose=False)


def test_lm_driver_vmap_matches_jax_vmap(jax_lm_vmap_run):
    seed, m = RUN["seed"], RUN["clients"]
    ref_out = jax_lm_vmap_run
    cfg = jget_config(RUN["arch"]).reduced()
    base = jax.tree.map(np.asarray,
                        jmodel.init_params(cfg, jax.random.key(seed))["base"])
    adapters = [jax.tree.map(np.asarray, jmodel.init_params(
        cfg, jax.random.key(seed + i))["adapter"]) for i in range(m)]
    probes = np.array(jax.random.normal(jax.random.key(seed + 99),
                                        (32, cfg.lora_rank), jnp.float32))
    out = train.run(**RUN, client_parallelism="vmap", device="cpu",
                    verbose=False,
                    base=convert.params_from_numpy(base, "cpu"),
                    init_adapters=[convert.params_from_numpy(a, "cpu")
                                   for a in adapters],
                    cka_probes=torch.from_numpy(probes),
                    sr_uniforms=_uniforms(seed, RUN["uplink_codec"],
                                          jtri_lora.tree_payload(
                                              adapters[0])))
    for a, b in zip(ref_out["history"], out["history"]):
        for key in ("round", "participants", "uplink_bytes",
                    "downlink_bytes", "uplink_floats"):
            assert a[key] == b[key], key
        assert abs(a["loss"] - b["loss"]) < 1e-4
    for j, t in zip(ref_out["adapters"], out["adapters"]):
        _assert_trees_close(jax.tree.map(np.asarray, j), t, 5e-4)


@pytest.mark.parametrize("kw", [dict(method="fedavg", uplink_codec="int4",
                                     clients=2),
                                dict(method="local", clients=2)])
def test_lm_driver_vmap_matches_loop(kw):
    run = {**RUN, "participation": 1.0, **kw}
    outs = {mode: train.run(**run, client_parallelism=mode, device="cpu",
                            verbose=False) for mode in ("loop", "vmap")}
    for a, b in zip(outs["loop"]["history"], outs["vmap"]["history"]):
        assert (a["participants"], a["uplink_bytes"], a["downlink_bytes"]) \
            == (b["participants"], b["uplink_bytes"], b["downlink_bytes"])
        assert abs(a["loss"] - b["loss"]) < 1e-4
    for a, b in zip(outs["loop"]["adapters"], outs["vmap"]["adapters"]):
        _assert_trees_close(a, b, 5e-4)


def test_lm_cli_takes_the_client_parallelism_flag(capsys):
    out = train.main(["--arch", "fed-100m", "--reduced", "--clients", "2",
                      "--rounds", "1", "--local-steps", "1", "--batch", "2",
                      "--seq", "16", "--client-parallelism", "loop",
                      "--device", "cpu"])
    assert len(out["history"]) == 1
    assert "over 1 rounds" in capsys.readouterr().out
