"""The port's dense configs qwen2.5-14b, qwen3-32b and starcoder2-7b,
its learning-rate schedules and its quickstart example, on the CPU.

Each config's reduced variant runs the causal-LM loss and its adapter
gradients on the JAX package's parameters (converted) and is held to the
JAX ``loss_fn`` at the f32 tolerances of the model tests: loss 1e-5,
gradients 1e-4 of their largest entry.  These configs exercise the QKV
bias (qwen2.5, starcoder2), per-head qk RMSNorm (qwen3), and LayerNorm +
GELU (starcoder2).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models.config import get_config as jget_config
from repro.optim import schedules as jschedules
from repro_torch import configs, convert
from repro_torch.models import model
from repro_torch.models.config import get_config, list_configs
from repro_torch.optim import schedules
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401

DENSE = ("qwen2.5-14b", "qwen3-32b", "starcoder2-7b")
ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", DENSE)
def test_config_fields_match_jax(name):
    assert name in list_configs()
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jget_config(name))


@pytest.mark.parametrize("name", jconfigs.ASSIGNED)
def test_every_assigned_config_is_registered_as_in_jax(name):
    """The registry: the port's ``ASSIGNED`` is the JAX package's, and each
    name resolves to the JAX config, field for field."""
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert name in list_configs()
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jget_config(name))


@pytest.mark.parametrize("name", DENSE)
def test_reduced_loss_and_grads_match_jax(name):
    jcfg = jget_config(name).reduced()
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jcfg, jax.random.key(1)))
    # move B off zero so that every adapter factor carries a gradient
    rng = np.random.default_rng(2)
    params["adapter"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        params["adapter"])
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda a: jmodel.loss_fn(jcfg, a, jax.tree.map(jnp.asarray,
                                                       params["base"]),
                                 jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jax.tree.map(jnp.asarray, params["adapter"]))
    cfg = get_config(name).reduced()
    ad = tree_map(lambda t: t.requires_grad_(True),
                  convert.params_from_numpy(params["adapter"], "cpu"))
    loss, _ = model.loss_fn(cfg, ad, convert.params_from_numpy(
        params["base"], "cpu"), {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(ad))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads), strict=True):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(jg).max()))


def test_schedules_match_jax():
    steps = np.array([0, 1, 5, 10, 37, 100, 150], np.int32)
    pairs = [(schedules.constant(3e-3), jschedules.constant(3e-3)),
             (schedules.cosine(1e-2, 100, 1e-4),
              jschedules.cosine(1e-2, 100, 1e-4)),
             (schedules.warmup_cosine(1e-2, 10, 100),
              jschedules.warmup_cosine(1e-2, 10, 100))]
    for ours, theirs in pairs:
        for s in steps:
            got = ours(torch.tensor(s))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got),
                                       float(theirs(jnp.asarray(s))),
                                       rtol=1e-6, atol=1e-9)


def test_quickstart_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu"])
    assert out["loss_after_step"] < out["loss"]
    assert out["full"] > out["payload"] > 0
    assert "CE-LoRA uplink" in capsys.readouterr().out
