"""The port's ``run_federated`` against the JAX package's, on the CPU.

Both packages run the eager engine's reference ``loop`` path on the same
numpy data and the same backbone; the JAX package's random draws (client
init, the CKA probe batch, the GMM initial means) are handed to the port.
Tolerances are those the JAX package holds its own engines to
(tests/test_client_store.py::_assert_history_close): identical sampled /
participant / dropped lists and byte ledgers, train loss within 1e-4,
accuracies within 1e-3, final states within 5e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import federated as jfed
from repro.core.baselines import get_strategy as jget_strategy
from repro.core.fed_model import FedTask as JFedTask
from repro.data import synthetic as jsynthetic
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.core import federated
from repro_torch.core.fed_model import FedTask
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
M, CLASSES = 4, 2
FED = dict(n_clients=M, rounds=2, local_steps=2, batch_size=8, lr=1e-2,
           seed=3, feature_samples=24, cka_probes=16, gmm_iters=10,
           client_parallelism="loop")


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
    return jtask, task, ctrain, ctest, {"draws": _jax_draws(jtask, FED)}


def _jax_draws(jtask, fed):
    """The JAX runtime's own draws: client init (federated.py:383-385),
    CKA probes (:539, one key for every refresh), GMM init indices
    (:278)."""
    ckeys = jax.random.split(jax.random.key(fed["seed"]), M)
    clients = [jax.tree.map(np.asarray, jtask.init_client(ckeys[i]))
               for i in range(M)]
    probes = np.asarray(jax.random.normal(
        jax.random.key(fed["seed"] + 97), (fed["cka_probes"],
                                           TINY["lora_rank"]), jnp.float32))

    def gmm_init(ci, k, n):
        return np.asarray(jax.random.choice(
            jax.random.key(fed["seed"] + 31 * ci + k), n, (2,),
            replace=False))
    return clients, probes, gmm_init


def _history(setup, method, participation):
    jtask, _, ctrain, ctest, memo = setup
    key = (method, participation)
    if key not in memo:
        fed = jfed.FedConfig(method=method, participation=participation,
                             **FED)
        memo[key] = jfed.run_federated(jtask, fed, ctrain, ctest)
    return memo[key]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


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


@pytest.mark.parametrize("participation", [1.0, 0.4])
@pytest.mark.parametrize("method", ["celora", "fedpetuning"])
def test_history_matches_jax_loop_path(setup, method, participation):
    _, task, ctrain, ctest, memo = setup
    ref = _history(setup, method, participation)
    clients, probes, gmm_init = memo["draws"]
    fed = federated.FedConfig(method=method, participation=participation,
                              **FED)
    out = federated.run_federated(
        task, fed, ctrain, ctest, device="cpu",
        init_clients=[convert.params_from_numpy(c, "cpu") for c in clients],
        cka_probes=torch.from_numpy(probes), gmm_init=gmm_init)
    assert len(ref["history"]) == len(out["history"]) == FED["rounds"]
    for r_ref, r_out in zip(ref["history"], out["history"]):
        assert r_ref.sampled == r_out.sampled
        assert r_ref.participants == r_out.participants
        assert r_ref.dropped == r_out.dropped
        assert r_ref.uplink_bytes == r_out.uplink_bytes
        assert r_ref.downlink_bytes == r_out.downlink_bytes
        assert r_ref.uplink_elems == r_out.uplink_elems
        assert abs(r_ref.train_loss - r_out.train_loss) < 1e-4
        np.testing.assert_allclose(r_ref.accs, r_out.accs, atol=1e-3)
    for s_ref, s_out in zip(ref["states"], out["states"]):
        want, got = _paths(jax.tree.map(np.asarray, s_ref)), _paths(s_out)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_allclose(_np(got[k]), want[k], atol=5e-4,
                                       err_msg=k)
    assert out["method"] == method and out["mean_acc"] == \
        pytest.approx(ref["mean_acc"], abs=1e-3)


def test_default_draws_train_every_strategy(setup):
    """The port's own generator draws: every strategy runs a round and
    prices the same bytes as the JAX package's strategy would."""
    _, task, ctrain, ctest, _ = setup
    for method in ("lora_loc", "ffa_lora", "fdlora", "pfedme_lora",
                   "pfedme_ffa", "celora_fedavg"):
        fed = federated.FedConfig(method=method, **{**FED, "rounds": 1,
                                                    "local_steps": 1})
        out = federated.run_federated(task, fed, ctrain, ctest, device="cpu")
        rec = out["history"][0]
        assert np.isfinite(rec.train_loss) and len(rec.accs) == M
        up = jget_strategy(method).uplink_keys
        assert (rec.uplink_bytes == 0) == (not up)


def _case(i, override, exc):
    """The case ids of the options' first parametrization, kept stable."""
    return pytest.param(override, exc, id=f"override{i}-{exc.__name__}")


@pytest.mark.parametrize("override,exc", [
    _case(0, dict(client_parallelism="shard"), NotImplementedError),
    _case(1, dict(client_parallelism="pmap"), ValueError),
    _case(2, dict(engine="scan", client_store="sharded"),
          NotImplementedError),
    _case(3, dict(engine="async", client_parallelism="shard"),
          NotImplementedError),
    _case(4, dict(client_store="host", client_parallelism="shard"),
          NotImplementedError),
    _case(5, dict(client_store="sharded"), NotImplementedError),
    _case(6, dict(uplink_codec="fp4"), ValueError),
    _case(7, dict(fault_crash=1.0), ValueError),
    _case(8, dict(fault_corrupt_mode="zero"), ValueError),
    _case(9, dict(admission="norm", method="lora_loc"), ValueError),
    _case(10, dict(eval_every=0), ValueError),
    _case(11, dict(checkpoint_path="x.npz"), ValueError),
    _case(12, dict(participation=0.0), ValueError),
    _case(13, dict(attn_impl="xla"), ValueError),
    _case(14, dict(engine="scan", client_parallelism="shard"),
          NotImplementedError),
    _case(15, dict(resume=True), ValueError),
    _case(16, dict(engine="scan", dispatch_timeout=1.0), ValueError),
])
def test_unported_options_raise(setup, override, exc):
    """The JAX package's refusals raise ``ValueError``; the options that
    raised ``NotImplementedError`` before the mesh layer was ported now
    run, bitwise their vmap / device-store counterparts."""
    _, task, ctrain, ctest, _ = setup

    def run(ov):
        fed = federated.FedConfig(**{**FED, **ov})
        return federated.run_federated(task, fed, ctrain, ctest,
                                       device="cpu")
    if exc is ValueError:
        with pytest.raises(ValueError):
            run(override)
        return
    if "client_store" not in override:
        override = dict(override, client_parallelism="shard")
    elif "client_parallelism" not in override:
        override = dict(override, client_parallelism="vmap")
    ref = dict(override, client_parallelism="vmap")
    if ref.get("client_store") == "sharded":
        ref["client_store"] = "device"
    out, want = run(override), run(ref)
    times = ("wall_s", "host_s", "device_s")
    for a, b in zip(out["history"], want["history"], strict=True):
        assert ({k: v for k, v in vars(a).items() if k not in times}
                == {k: v for k, v in vars(b).items() if k not in times})
    for sa, sb in zip(out["states"], want["states"], strict=True):
        la, lb = tree_leaves(sa), tree_leaves(sb)
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_fed_config_fields_match_jax():
    """Every JAX FedConfig field exists with the same default."""
    ours = {f.name: f.default for f in dataclasses.fields(
        federated.FedConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jfed.FedConfig)}
    assert ours == theirs
    assert {f.name for f in dataclasses.fields(federated.RoundRecord)} == \
        {f.name for f in dataclasses.fields(jfed.RoundRecord)}


def test_cuda_request_without_a_card_raises(setup):
    _, task, ctrain, ctest, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-tensor check is the test")
    with pytest.raises(RuntimeError, match="cuda"):
        federated.run_federated(task, federated.FedConfig(**FED), ctrain,
                                ctest)


def test_task_on_another_device_raises(setup):
    _, task, ctrain, ctest, _ = setup
    meta = FedTask(task.cfg, {"embed": torch.zeros(2, device="meta")},
                   CLASSES)
    with pytest.raises(ValueError, match="task.base"):
        federated.run_federated(meta, federated.FedConfig(**FED), ctrain,
                                ctest, device="cpu")


def test_cli_trains_on_the_cpu(capsys):
    from repro_torch.launch import federated as cli
    out = cli.main(["--arch", "fed-100m", "--reduced", "--clients", "2",
                    "--rounds", "1", "--local-steps", "1", "--batch", "2",
                    "--seq", "8", "--n-train", "4", "--n-test", "2",
                    "--device", "cpu"])
    assert len(out["history"]) == 1 and out["uplink_bytes_per_round"] > 0
    assert "round   0" in capsys.readouterr().out
