"""The port's DLG gradient-inversion harness (``repro_torch.core.privacy``)
against the JAX package's (``repro.core.privacy``), on the CPU.

The JAX package draws its surrogate model and the attacker's dummy
initialization from ``jax.random``; the port draws from a
``torch.Generator``.  So the parity tests hand the JAX draws to the port:
the JAX ``make_model``'s arrays through ``convert.dlg_model_from_numpy``
and the JAX ``dlg_attack``'s dummy (the two normals of the split key
``seed + 7``) as ``dummy``.  Held: the observed gradients of every payload
within 1e-5 of their largest entry, 20 attack steps' recovered bag within
1e-4, and ``run_dlg_experiment``'s F1 per method at 120 steps equal to the
JAX run's (and at 300 steps at seeds 1-4, where the example's ordering
must hold on those draws).  The port's own ``make_model`` draws must be pairwise
decorrelated, as ``tests/test_drivers.py`` requires of the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import privacy as jprivacy
from repro_torch import convert
from repro_torch.core import privacy
from torch_threads import one_torch_thread  # noqa: F401

SEED = 0


def _jax_draws(seed: int):
    """The JAX run's draws at ``seed`` in both packages: the JAX model, the
    port's model on its arrays, the dummy (the two normals of the split key
    ``seed + 7``), and the private batch."""
    fields = jax.jit(lambda k: dataclasses.astuple(jprivacy.make_model(k))[
        :4])(jax.random.key(seed))
    jm = jprivacy.DLGModel(*fields)
    arrays = {"embed": jm.embed, "w": jm.w, "head": jm.head,
              "adapter": jm.adapter}
    m = convert.dlg_model_from_numpy(jax.tree.map(np.asarray, arrays),
                                     device="cpu", scaling=jm.scaling)
    k1, k2 = jax.random.split(jax.random.key(seed + 7))
    dummy = {"x": np.asarray(jax.random.normal(k1, (4, 128)) * 0.1),
             "y": np.asarray(jax.random.normal(k2, (4, 4)) * 0.1)}
    true, labels = privacy.private_batch(seed, 4, 6, 128)
    return jm, m, {k: torch.from_numpy(v.copy()) for k, v in dummy.items()}, \
        true, labels


@pytest.fixture(scope="module")
def models():
    return _jax_draws(SEED)


def test_private_batch_is_the_jax_stream():
    """The port's numpy draw of the private batch is the JAX run's."""
    true, labels = privacy.private_batch(3, 4, 6, 128)
    rng = np.random.default_rng(3)
    want = np.zeros((4, 128), np.float32)
    for i in range(4):
        want[i, rng.choice(128, 6, replace=False)] = 1.0 / 6
    np.testing.assert_array_equal(true, want)
    np.testing.assert_array_equal(labels, np.asarray(jax.nn.one_hot(
        jnp.asarray(rng.integers(0, 4, 4)), 4)))


@pytest.mark.parametrize("method", sorted(privacy.PAYLOADS))
def test_observed_grads_match_jax(models, method):
    jm, m, _, true, labels = models
    payload = privacy.PAYLOADS[method]
    assert payload == jprivacy.PAYLOADS[method]
    jg = jprivacy.observed_grads(jm, payload, jnp.asarray(true),
                                 jnp.asarray(labels))
    g = privacy.observed_grads(m, payload, torch.from_numpy(true),
                               torch.from_numpy(labels))
    assert sorted(g) == sorted(jg) == sorted(payload)
    for k in g:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(g[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("method", ["celora", "fedpetuning"])
def test_attack_steps_match_jax(models, method):
    jm, m, dummy, true, labels = models
    payload = privacy.PAYLOADS[method]
    jg = jprivacy.observed_grads(jm, payload, jnp.asarray(true),
                                 jnp.asarray(labels))
    want = np.asarray(jprivacy.dlg_attack(jm, payload, jg, 4,
                                          jax.random.key(SEED + 7),
                                          n_steps=20))
    g = privacy.observed_grads(m, payload, torch.from_numpy(true),
                               torch.from_numpy(labels))
    got = privacy.dlg_attack(m, payload, g, 4, n_steps=20, dummy=dummy)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert float(np.abs(want - np.asarray(jax.nn.softmax(
        jnp.asarray(dummy["x"].numpy()), -1))).max()) > 1e-4   # it moved


def test_run_dlg_experiment_f1_matches_jax(models):
    jm, m, dummy, _, _ = models
    want = jprivacy.run_dlg_experiment(seed=SEED, n_steps=120)
    got = privacy.run_dlg_experiment(seed=SEED, n_steps=120, device="cpu",
                                     model=m, dummy=dummy)
    assert list(got) == list(want)
    for method in want:
        for k in ("precision", "recall", "f1"):
            assert got[method][k] == pytest.approx(want[method][k],
                                                   abs=1e-12), (method, k)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_run_dlg_experiment_f1_matches_jax_at_other_seeds(seed):
    """At 300 attack steps the port on the JAX run's draws gives the JAX
    run's F1, method for method, at seeds 1-4 too; and on those draws the
    example's ordering (celora F1 <= fedpetuning F1 + 0.05) holds, so a
    run that breaks it on other draws (the card's torch generators at
    seeds 2 and 3) shows the spread of 4 x 6 private tokens, not a fault
    of the port."""
    _, m, dummy, _, _ = _jax_draws(seed)
    want = jprivacy.run_dlg_experiment(seed=seed, n_steps=300)
    got = privacy.run_dlg_experiment(seed=seed, n_steps=300, device="cpu",
                                     model=m, dummy=dummy)
    assert list(got) == list(want)
    for method in want:
        for k in ("precision", "recall", "f1"):
            assert got[method][k] == pytest.approx(want[method][k],
                                                   abs=1e-12), (method, k)
    assert got["celora"]["f1"] <= got["fedpetuning"]["f1"] + 0.05


def test_make_model_draws_decorrelated():
    """The frozen base and the adapter perturbations are independent draws
    of the generator's stream: pairwise |corr| < 0.5."""
    model = privacy.make_model(torch.Generator().manual_seed(0))
    rank = model.adapter["C"].shape[0]
    draws = {
        "embed": model.embed.numpy().ravel(),
        "w": model.w.numpy().ravel(),
        "head": model.head.numpy().ravel(),
        "A": model.adapter["A"].numpy().ravel(),
        "B": model.adapter["B"].numpy().ravel(),
        "C_perturb": (model.adapter["C"].numpy()
                      - np.eye(rank, dtype=np.float32)).ravel(),
    }
    names = sorted(draws)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            n = min(draws[a].size, draws[b].size)
            corr = np.corrcoef(draws[a][:n], draws[b][:n])[0, 1]
            assert abs(corr) < 0.5, (a, b, corr)


def test_example_runs_on_the_cpu(capsys):
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parent.parent / "examples"
            / "privacy_attack_torch.py")
    spec = importlib.util.spec_from_file_location("privacy_attack_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--steps", "30"])
    assert set(res) == set(privacy.PAYLOADS)
    assert "OK" in capsys.readouterr().out
