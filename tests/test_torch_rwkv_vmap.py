"""RWKV-6 under vectorized clients (``client_parallelism="vmap"``, the
default of both packages) in the port, on the CPU.

The time mix's r/k/v/o projections take each client's adapter per
sequence (``adapter_rows``), so the LM driver and ``run_federated`` run an
rwkv6 arch with their defaults.  The port's vmap run of the LM driver is
held to the JAX package's vmap run (its draws handed in: backbone,
adapters, CKA probes) and to the port's loop run: loss within 1e-4,
adapters within 5e-4, identical ledgers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.models.config import get_config as jget_config
from repro_torch import convert
from repro_torch.launch import federated as fed_cli
from repro_torch.launch import train
from repro_torch.models import model, transformer
from repro_torch.models.config import get_config
from torch_threads import one_torch_thread  # noqa: F401

RUN = dict(arch="rwkv6-1.6b", reduced=True, clients=2, rounds=1,
           local_steps=2, batch=2, seq=16, lr=3e-3, seed=4, method="celora")
LEDGER = ("round", "participants", "uplink_bytes", "downlink_bytes",
          "uplink_floats")


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


def _assert_close(want, got, atol):
    wp, gp = _paths(want), _paths(got)
    assert wp.keys() == gp.keys()
    for k, v in wp.items():
        g = gp[k]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = v.detach().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        np.testing.assert_allclose(g, w, atol=atol, err_msg=k)


def _assert_runs_close(ref, out):
    for a, b in zip(ref["history"], out["history"], strict=True):
        assert [a[k] for k in LEDGER] == [b[k] for k in LEDGER]
        assert abs(a["loss"] - b["loss"]) < 1e-4
    for j, t in zip(ref["adapters"], out["adapters"], strict=True):
        _assert_close(jax.tree.map(np.asarray, j)
                      if not isinstance(jax.tree.leaves(j)[0], torch.Tensor)
                      else j, t, 5e-4)


def test_rwkv_block_takes_grouped_adapters():
    """block_apply on an rwkv6 block with stacked adapters and
    adapter_rows equals each client's own block, sequence by sequence."""
    cfg = get_config("rwkv6-1.6b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = transformer.init_block(gen, cfg, "rwkv6")
    ads = [transformer.init_block_adapters(gen, cfg, "rwkv6")
           for _ in range(3)]
    for ad in ads:                  # move B off zero: a delta per client
        for a in _paths(ad).values():
            a.add_(0.05 * torch.randn(a.shape, generator=gen))
    stacked = jax.tree.map(lambda *xs: torch.stack(xs), *ads,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
    x = torch.randn((6, 7, cfg.d_model), generator=gen)
    rows = torch.tensor([2, 0, 1, 1, 0, 2], dtype=torch.int32)
    y, _ = transformer.block_apply(cfg, "rwkv6", p, stacked, x, None,
                                   adapter_rows=rows)
    for i, c in enumerate(rows.tolist()):
        want, _ = transformer.block_apply(cfg, "rwkv6", p, ads[c],
                                          x[i:i + 1], None)
        torch.testing.assert_close(y[i:i + 1], want, atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jax_vmap_run():
    """The JAX package's LM-driver vmap run on rwkv6-1.6b (one compile)."""
    return jtrain.run(**RUN, client_parallelism="vmap", verbose=False)


def test_lm_driver_rwkv_vmap_matches_jax_vmap(jax_vmap_run):
    seed, m = RUN["seed"], RUN["clients"]
    cfg = jget_config(RUN["arch"]).reduced()
    base = jax.tree.map(np.asarray,
                        jmodel.init_params(cfg, jax.random.key(seed))["base"])
    adapters = [jax.tree.map(np.asarray, jmodel.init_params(
        cfg, jax.random.key(seed + i))["adapter"]) for i in range(m)]
    probes = np.array(jax.random.normal(jax.random.key(seed + 99),
                                        (train.CKA_PROBES, cfg.lora_rank),
                                        jnp.float32))
    out = train.run(**RUN, verbose=False, device="cpu",
                    base=convert.params_from_numpy(base, "cpu"),
                    init_adapters=[convert.params_from_numpy(a, "cpu")
                                   for a in adapters],
                    cka_probes=torch.from_numpy(probes))
    _assert_runs_close(jax_vmap_run, out)


def test_lm_driver_rwkv_vmap_matches_loop():
    """The default (vmap) against the clients one after another."""
    outs = {mode: train.run(**RUN, client_parallelism=mode, device="cpu",
                            verbose=False) for mode in ("vmap", "loop")}
    _assert_runs_close(outs["loop"], outs["vmap"])


def test_federated_cli_runs_rwkv_with_its_default():
    out = fed_cli.main(["--arch", "rwkv6-1.6b", "--reduced", "--clients",
                        "2", "--rounds", "1", "--local-steps", "1",
                        "--batch", "2", "--seq", "16", "--n-train", "8",
                        "--n-test", "4", "--device", "cpu"])
    rec = out["history"][0]
    assert np.isfinite(rec.train_loss) and rec.uplink_bytes > 0
    assert model.client_rows(2, 2, "cpu").tolist() == [0, 0, 1, 1]
