"""The port's causal-LM federated driver (``launch.train.run``) and its
compressed ``run_federated`` against the JAX package's, on the CPU.

Both packages run the eager engine's reference ``loop`` path on the same
numpy streams; the JAX package's random draws — backbone, client
adapters / client init, CKA probes, GMM initial means and the codec's
stochastic-rounding uniforms — are handed to the port.  Tolerances are the
ones the JAX package holds its own engines to (ROADMAP): identical
participant and byte ledgers, loss within 1e-4, final adapters and states
within 5e-4 (accuracies within 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcompress
from repro.core import federated as jfed
from repro.core import tri_lora as jtri_lora
from repro.core.baselines import get_strategy as jget_strategy
from repro.core.fed_model import FedTask as JFedTask
from repro.data import synthetic as jsynthetic
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JConfig
from repro.models.config import get_config as jget_config
from repro_torch import checkpoint, convert
from repro_torch.core import federated
from repro_torch.launch import train
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

RUN = dict(arch="fed-100m", reduced=True, rounds=2, local_steps=2, batch=2,
           seq=32, lr=3e-3, seed=5)
CASES = {"celora-int8-half": dict(method="celora", uplink_codec="int8",
                                  participation=0.5, clients=3),
         "fedavg-none": dict(method="fedavg", uplink_codec="none",
                             clients=2)}


def _uniforms(seed: int, codec_name: str, like):
    """(round, client) → the uniforms ``compress.encode`` draws from
    ``client_key(seed, round, client)`` for a payload shaped like ``like``,
    one (n_tiles, tile) tensor per leaf in the JAX package's order."""
    codec = jcompress.get_codec(codec_name)
    sizes = [int(np.prod(np.shape(l))) for l in jax.tree.leaves(like)]

    def draw(rnd: int, i: int) -> list:
        keys = jax.random.split(jcompress.client_key(seed, rnd, i),
                                len(sizes))
        out = []
        for n, k in zip(sizes, keys):
            tile = jcompress._leaf_tile(n, codec.pack)
            out.append(torch.from_numpy(np.array(
                jax.random.uniform(k, (-(-n // tile), tile)))))
        return out
    return draw


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


def _assert_trees_close(jtree, ttree, atol: float) -> None:
    jp, tp = _paths(jax.tree.map(np.asarray, jtree)), _paths(ttree)
    assert jp.keys() == tp.keys()
    for k, v in jp.items():
        np.testing.assert_allclose(tp[k].detach().float().numpy(),
                                   np.asarray(v, np.float32), atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_lm_driver_matches_jax_loop_path(case, tmp_path):
    kw = {**RUN, **CASES[case]}
    seed, m = kw["seed"], kw["clients"]
    ref = jtrain.run(**kw, client_parallelism="loop", verbose=False)

    cfg = jget_config(kw["arch"]).reduced()
    base = jax.tree.map(np.asarray,
                        jmodel.init_params(cfg, jax.random.key(seed))["base"])
    adapters = [jax.tree.map(np.asarray, jmodel.init_params(
        cfg, jax.random.key(seed + i))["adapter"]) for i in range(m)]
    probes = np.array(jax.random.normal(jax.random.key(seed + 99),
                                          (32, cfg.lora_rank), jnp.float32))
    like = (jtri_lora.tree_payload(adapters[0])
            if kw["method"] == "celora" else adapters[0])
    path = str(tmp_path / "lm.npz")
    out = train.run(**kw, client_parallelism="loop", device="cpu",
                    verbose=False, ckpt=path,
                    base=convert.params_from_numpy(base, "cpu"),
                    init_adapters=[convert.params_from_numpy(a, "cpu")
                                   for a in adapters],
                    cka_probes=torch.from_numpy(probes),
                    sr_uniforms=_uniforms(seed, kw["uplink_codec"], like))

    assert len(out["history"]) == len(ref["history"]) == kw["rounds"]
    for r_ref, r_out in zip(ref["history"], out["history"]):
        for key in ("round", "participants", "uplink_bytes",
                    "downlink_bytes", "uplink_floats"):
            assert r_ref[key] == r_out[key], key
        assert abs(r_ref["loss"] - r_out["loss"]) < 1e-4
    for j, t in zip(ref["adapters"], out["adapters"]):
        _assert_trees_close(j, t, 5e-4)
    assert checkpoint.metadata(path)["method"] == kw["method"]
    back = checkpoint.restore(path, {"adapter_client0": out["adapters"][0]})
    _assert_trees_close(out["adapters"][0], back["adapter_client0"], 0.0)


@pytest.mark.parametrize("override,exc", [
    # the sharded store runs (it raised until the mesh layer was ported):
    # bitwise the device store, on the eager and the scan engine
    pytest.param(dict(engine="scan", client_store="sharded"), None,
                 id="override0"),
    # async and the host store are ported: the JAX package's ValueErrors
    pytest.param(dict(engine="async", client_parallelism="loop"), ValueError,
                 id="override1"),
    pytest.param(dict(client_store="host", client_parallelism="loop"),
                 ValueError, id="override2"),
    pytest.param(dict(client_store="sharded"), None, id="override3"),
    # resume needs the scan engine's state file: a ValueError, as in JAX
    pytest.param(dict(resume=True), ValueError, id="override4"),
    pytest.param(dict(engine="scan", client_parallelism="loop"),
                 ValueError, id="override5"),
    pytest.param(dict(engine="scan", client_store="host"), ValueError,
                 id="override6"),
])
def test_unported_lm_options_raise(override, exc):
    def run(ov):
        return train.run(**{**RUN, "clients": 2, **ov}, device="cpu",
                         verbose=False)
    if exc is not None:
        with pytest.raises(exc):
            run(override)
        return
    out, ref = run(override), run(dict(override, client_store="device"))
    times = ("wall_s", "host_s", "device_s")
    for a, b in zip(out["history"], ref["history"], strict=True):
        assert ({k: v for k, v in a.items() if k not in times}
                == {k: v for k, v in b.items() if k not in times})
    for a, b in zip(out["adapters"], ref["adapters"], strict=True):
        assert all(torch.equal(x, y)
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_cli_trains_on_the_cpu(capsys):
    out = train.main(["--arch", "fed-100m", "--reduced", "--clients", "2",
                      "--rounds", "2", "--local-steps", "1", "--batch", "2",
                      "--seq", "16", "--uplink-codec", "int4",
                      "--device", "cpu"])
    assert len(out["history"]) == 2 and out["history"][0]["uplink_bytes"] > 0
    assert "over 2 rounds" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# run_federated with an uplink codec (the classification runtime)
# ---------------------------------------------------------------------------

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
M, CLASSES = 4, 2
FED = dict(method="celora", n_clients=M, rounds=2, local_steps=2,
           batch_size=8, lr=1e-2, seed=3, feature_samples=24,
           cka_probes=16, gmm_iters=10, participation=0.5,
           uplink_codec="int8", client_parallelism="loop")


def test_run_federated_int8_matches_jax_loop_path():
    ctrain, ctest, _ = jsynthetic.make_federated_classification(
        0, M, 40, 12, 16, TINY["vocab_size"], CLASSES, drift=0.8)
    jcfg = JConfig(**TINY)
    base = jax.jit(lambda k: JFedTask.create(k, jcfg, CLASSES).base)(
        jax.random.key(0))
    jtask = JFedTask(jcfg, base, CLASSES)
    ref = jfed.run_federated(jtask, jfed.FedConfig(**FED), ctrain, ctest)

    seed = FED["seed"]
    ckeys = jax.random.split(jax.random.key(seed), M)
    clients = [jax.tree.map(np.asarray, jtask.init_client(ckeys[i]))
               for i in range(M)]
    probes = np.array(jax.random.normal(
        jax.random.key(seed + 97), (FED["cka_probes"], TINY["lora_rank"]),
        jnp.float32))

    def gmm_init(ci, k, n):
        return np.asarray(jax.random.choice(
            jax.random.key(seed + 31 * ci + k), n, (2,), replace=False))

    like = jget_strategy("celora").uplink(clients[0])
    task = convert.fed_task_from_numpy(ModelConfig(**TINY),
                                       jax.tree.map(np.asarray, base),
                                       CLASSES, "cpu")
    out = federated.run_federated(
        task, federated.FedConfig(**FED), ctrain, ctest, device="cpu",
        init_clients=[convert.params_from_numpy(c, "cpu") for c in clients],
        cka_probes=torch.from_numpy(probes), gmm_init=gmm_init,
        sr_uniforms=_uniforms(seed, "int8", like))

    for r_ref, r_out in zip(ref["history"], out["history"]):
        assert r_ref.participants == r_out.participants
        assert (r_ref.uplink_bytes, r_ref.downlink_bytes,
                r_ref.uplink_elems) == (r_out.uplink_bytes,
                                        r_out.downlink_bytes,
                                        r_out.uplink_elems)
        assert abs(r_ref.train_loss - r_out.train_loss) < 1e-4
        np.testing.assert_allclose(r_ref.accs, r_out.accs, atol=1e-3)
    for j, t in zip(ref["states"], out["states"]):
        assert set(j) == set(t) and "ef" in t
        _assert_trees_close(j, t, 5e-4)
