"""The port's sliding-window (``swa``) blocks and the h2o-danube-3-4b
config, on the CPU.

The reduced config (2 layers, width 256, head dim 64, window 64) runs the
causal-LM loss and its adapter gradients on the JAX package's parameters
(converted) at 128 tokens, so the window cuts every row past the 64th;
the port's attention goes through ``attn_impl="flash"`` (the flash
kernels' plain version here), the JAX package's through its reference
SDPA.  Held at loss 1e-4 and gradients 5e-4 of their largest entry; the
same at head dim 120, the full config's.  Greedy ``generate`` runs past
a 16-slot ring (window 16), so the cache wraps, and must give the JAX
package's tokens; ``ServeEngine`` must give the JAX ``ServeEngine``'s
and the port's ``serve_naive``'s across the wrap.
Both training drivers run the reduced model on their default vectorized
clients.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adapter_bank as jbank_mod
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models.config import get_config as jget_config
from repro_torch import convert
from repro_torch.launch import federated as fed_cli
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import model
from repro_torch.models.config import get_config, list_configs
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "h2o-danube-3-4b"
ROOT = Path(__file__).resolve().parent.parent


def test_config_fields_match_jax():
    assert ARCH in list_configs()
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(ARCH))
    assert cfg.layer_pattern == ("swa",) and cfg.hd == 120
    assert cfg.reduced().window == 64


def _jax_params(jcfg, seed):
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jcfg, jax.random.key(seed)))
    # move B off zero so that every adapter factor carries a gradient
    rng = np.random.default_rng(seed + 1)
    params["adapter"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        params["adapter"])
    return params


@pytest.mark.parametrize("head_dim", [64, 120])
def test_reduced_loss_and_grads_match_jax(head_dim):
    jcfg = jget_config(ARCH).reduced(head_dim=head_dim)
    params = _jax_params(jcfg, 3)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 129)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda a, b, x: jmodel.loss_fn(jcfg, a, b, x), has_aux=True))(
        *(jax.tree.map(jnp.asarray, t)
          for t in (params["adapter"], params["base"], batch)))
    cfg = get_config(ARCH).reduced(head_dim=head_dim, attn_impl="flash")
    base = convert.params_from_numpy(params["base"], "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ad = tree_map(lambda t: t.requires_grad_(True),
                  convert.params_from_numpy(params["adapter"], "cpu"))
    loss, _ = model.loss_fn(cfg, ad, base, tbatch)
    grads = torch.autograd.grad(loss, tree_leaves(ad))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4)
    for g, jg in zip(grads, jax.tree.leaves(jgrads), strict=True):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=5e-4 * max(1.0, np.abs(jg).max()))
    # the window is what sets these numbers: full attention differs
    with torch.no_grad():
        full, _ = model.loss_fn(cfg.with_overrides(layer_pattern=("attn",)),
                                ad, base, tbatch)
    assert abs(float(full) - float(loss.detach())) > 1e-4


def test_decode_ring_is_sized_as_jax():
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    for seq_len in (40, 100):
        got = model.init_decode_cache(cfg, 2, seq_len, device="cpu")
        want = jmodel.init_decode_cache(jcfg, 2, seq_len)
        for key in ("k", "v", "idx"):
            assert tuple(got["groups"]["0"][key].shape) == \
                want["groups"]["0"][key].shape
        assert got["groups"]["0"]["k"].shape[2] == min(seq_len, 64)


#: the ring tests' window: 16 slots, wrapped by 24-token sequences
RING = 16


def test_generate_matches_jax_across_the_ring_wrap():
    """12 prompt and 12 new tokens over a 16-slot ring: the last 8 steps
    overwrite the oldest slots."""
    jcfg = jget_config(ARCH).reduced(window=RING)
    params = _jax_params(jcfg, 5)
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jserve.generate(
        jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(prompts), 12))
    got = serve.generate(get_config(ARCH).reduced(window=RING),
                         convert.params_from_numpy(params, "cpu"), prompts,
                         12, device="cpu")
    assert got.shape == (2, 24)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_matches_naive_across_the_ring_wrap():
    """4 requests of 12 + 12 tokens from 4 users through 2 slots: every
    request wraps the 16-slot ring and slots are reused (the ragged
    per-slot ring index).  The port's engine must give the JAX engine's
    tokens on the same params, bank and requests, and serve_naive's."""
    jcfg = jget_config(ARCH).reduced(window=RING)
    jbase = jmodel.init_params(jcfg, jax.random.key(7))["base"]
    jbank = jbank_mod.random_bank(jcfg, 4, jax.random.key(8))
    reqs = jserve.make_requests(jbank, 4, prompt_len=12, gen=12,
                                vocab=jcfg.vocab_size, seed=8)
    jax_tokens = jserve.ServeEngine(jcfg, jbase, jbank, slots=2,
                                    max_len=24).run(reqs)
    cfg = get_config(ARCH).reduced(window=RING)
    base = convert.params_from_numpy(jax.tree.map(np.asarray, jbase), "cpu")
    bank = convert.bank_from_numpy(jax.tree.map(np.asarray, jbank.tree),
                                   users=jbank.users, device="cpu")
    eng = serve.ServeEngine(cfg, base, bank, slots=2, max_len=24,
                            device="cpu")
    got = eng.run(reqs)
    naive = serve.serve_naive(cfg, base, bank, reqs, device="cpu")
    for want, what in ((jax_tokens, "JAX engine"), (naive, "serve_naive")):
        assert set(got) == set(want) == {r.rid for r in reqs}
        for r in reqs:
            assert got[r.rid].shape == (24,)
            np.testing.assert_array_equal(got[r.rid], want[r.rid],
                                          err_msg=f"{what}: rid={r.rid}")


def test_both_drivers_train_swa_with_their_defaults():
    """``run_federated`` through its CLI and the LM driver, each on its
    default client_parallelism ("vmap"), at 96 tokens against the reduced
    window of 64; the LM driver's vmap round 0 equals its loop round 0."""
    out = fed_cli.main(["--arch", ARCH, "--reduced", "--clients", "2",
                        "--rounds", "1", "--local-steps", "1", "--batch",
                        "2", "--seq", "96", "--n-train", "4", "--n-test",
                        "2", "--attn-impl", "flash", "--device", "cpu"])
    rec = out["history"][0]
    assert np.isfinite(rec.train_loss) and rec.uplink_bytes > 0
    kw = dict(arch=ARCH, reduced=True, clients=2, rounds=1, local_steps=1,
              batch=1, seq=96, attn_impl="flash", verbose=False,
              device="cpu")
    vmap, loop = (train.run(**kw, client_parallelism=m)["history"][0]
                  for m in ("vmap", "loop"))
    assert vmap["uplink_bytes"] == loop["uplink_bytes"] > 0
    np.testing.assert_allclose(vmap["loss"], loop["loss"], rtol=1e-5)


def test_serve_batched_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "serve_batched_torch", ROOT / "examples" / "serve_batched_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    outs = mod.main(["--device", "cpu"])
    assert set(outs) == {"h2o-danube-3-4b", "rwkv6-1.6b"}
    for out in outs.values():
        assert out.shape == (4, 28) and (out >= 0).all()
    assert capsys.readouterr().out.rstrip().endswith("OK")
