"""The port's RG-LRU block (``models/rglru.py``), the hybrid
recurrentgemma-2b config (pattern rglru, rglru, swa) and the flash
kernels' head dim 256, on the CPU.

The same seeded numpy inputs go through the JAX package and the port, f32,
at 2e-5 unless a test says otherwise: ``rglru_block``'s output and final
state (h and the conv tail) over T = 1100 steps (three 512-step scan
chunks, the last padded), from a zero state and from an incoming one; the
gradients of the w_in / w_out adapters through it; the reduced config's
loss and adapter gradients (128 tokens past a 64-token window, the port's
attention through ``attn_impl="flash"``; gradients at 1e-4 of their
largest entry, the other model tests' f32 tolerance); the vectorized
clients (``adapter_rows``) against each client alone; one training step of
the LM driver on vmap and on loop; token-by-token decode against the
forward at 2e-3 across a ring wrap; and the flash wrapper's head dims
(256 taken, 96 refused) against the dims the .cu instantiates.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models.config import get_config as jget_config
from repro_torch import convert
from repro_torch.core import client_batch
from repro_torch.core.adapter_bank import random_bank
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve, train
from repro_torch.models import model, rglru
from repro_torch.models.config import get_config, list_configs
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "recurrentgemma-2b"
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 1e-4


def test_config_fields_match_jax():
    assert ARCH in list_configs()
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(ARCH))
    assert cfg.layer_pattern == ("rglru", "rglru", "swa")
    assert (cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.window) == \
        (256, 10, 1, 2048)
    assert cfg.kinds().count("swa") == 8 and cfg.n_layers == 26


def _block_inputs(seed, t, with_state):
    jcfg = jget_config(ARCH).reduced()
    p = jax.tree.map(np.asarray, jrglru.init_rglru_block(
        jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"conv": rng.standard_normal(
            (2, jcfg.conv1d_width - 1, jcfg.rnn_d)).astype(np.float32),
            "h": rng.standard_normal((2, jcfg.rnn_d)).astype(np.float32)}
    return jcfg, p, x, state


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_matches_jax(with_state):
    jcfg, p, x, state = _block_inputs(0, 1100, with_state)
    jout, jst = jrglru.rglru_block(
        jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        None if state is None else jax.tree.map(jnp.asarray, state))
    cfg = get_config(ARCH).reduced()
    tp = convert.params_from_numpy(p, "cpu")
    assert tp["lam"].dtype == torch.float32
    with torch.no_grad():
        out, st = rglru.rglru_block(
            cfg, tp, torch.from_numpy(x), None if state is None else
            convert.params_from_numpy(state, "cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(st["h"].numpy(), np.asarray(jst["h"]), **TOL)
    # the conv tail: the last cw - 1 conv inputs, exactly
    np.testing.assert_array_equal(st["conv"].numpy(), np.asarray(jst["conv"]))
    assert st["h"].dtype == torch.float32


def test_chunked_scan_is_the_recurrence():
    """The chunked log-depth scan equals the step-by-step recurrence in
    float64 (ragged tail, carried h0)."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 1100, 8), generator=g, dtype=torch.float64) * 0.2 + 0.8
    b = torch.randn((2, 1100, 8), generator=g, dtype=torch.float64)
    h0 = torch.randn((2, 8), generator=g, dtype=torch.float64)
    got = rglru._chunked_linear_scan(a, b, h0)
    h, want = h0, []
    for t in range(1100):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_adapter_grads_through_w_in_w_out_match_jax():
    jcfg, p, x, _ = _block_inputs(2, 600, False)
    rng = np.random.default_rng(5)
    ad = {t: {"A": rng.standard_normal((din, 4)).astype(np.float32) * 0.5,
              "C": np.eye(4, dtype=np.float32)
              + 0.1 * rng.standard_normal((4, 4)).astype(np.float32),
              "B": rng.standard_normal((4, dout)).astype(np.float32) * 0.01}
          for t, (din, dout) in (("w_in", (jcfg.d_model, 2 * jcfg.rnn_d)),
                                 ("w_out", (jcfg.rnn_d, jcfg.d_model)))}
    ct = rng.standard_normal(x.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    jout, vjp = jax.vjp(lambda a: jrglru.rglru_block(
        jcfg, jp, jnp.asarray(x), None, a)[0], jax.tree.map(jnp.asarray, ad))
    (jg,) = vjp(jnp.asarray(ct))
    cfg = get_config(ARCH).reduced()
    tad = tree_map(lambda t: t.requires_grad_(True),
                   convert.params_from_numpy(ad, "cpu"))
    out, _ = rglru.rglru_block(cfg, convert.params_from_numpy(p, "cpu"),
                               torch.from_numpy(x), None, tad)
    grads = torch.autograd.grad(out, tree_leaves(tad), torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    names = [(t, f) for t in tad for f in tad[t]]
    for (t, f), g in zip(names, grads, strict=True):
        want = np.asarray(jg[t][f])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())


def _jax_params(jcfg, seed):
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)
    params["adapter"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        params["adapter"])
    return params


def test_reduced_loss_and_grads_match_jax():
    jcfg = jget_config(ARCH).reduced()
    params = _jax_params(jcfg, 3)
    assert set(params["adapter"]["groups"]["0"]) == {"rec"}
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 129)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda a, b, x: jmodel.loss_fn(jcfg, a, b, x), has_aux=True))(
        *(jax.tree.map(jnp.asarray, t)
          for t in (params["adapter"], params["base"], batch)))
    cfg = get_config(ARCH).reduced(attn_impl="flash")
    ad = tree_map(lambda t: t.requires_grad_(True),
                  convert.params_from_numpy(params["adapter"], "cpu"))
    loss, m = model.loss_fn(cfg, ad, convert.params_from_numpy(
        params["base"], "cpu"), {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(ad))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    for g, jg in zip(grads, jax.tree.leaves(jgrads), strict=True):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=GRAD_TOL * max(1.0, np.abs(jg).max()))


def test_vmap_rows_equal_each_client_alone():
    """Two clients' adapters stacked, their batches folded into one:
    each client's loss and adapter gradients equal its own run's."""
    cfg = get_config(ARCH).reduced()
    gen = torch.Generator().manual_seed(6)
    params = model.init_params(cfg, gen)
    ads = [tree_map(lambda t: t + 0.05 * torch.randn(t.shape, generator=gen),
                    params["adapter"]) for _ in range(2)]
    toks = torch.randint(0, cfg.vocab_size, (4, 81), generator=gen)
    tb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    stacked = tree_map(lambda t: t.requires_grad_(True),
                       client_batch.stack_states(ads))
    loss, _ = model.loss_fn(cfg, stacked, params["base"], tb,
                            adapter_rows=model.client_rows(2, 2, "cpu"))
    grads = torch.autograd.grad(loss.sum(), tree_leaves(stacked))
    for i in range(2):
        ad = tree_map(lambda t: t.detach().requires_grad_(True), ads[i])
        one, _ = model.loss_fn(cfg, ad, params["base"],
                               {k: v[2 * i:2 * i + 2] for k, v in tb.items()})
        np.testing.assert_allclose(float(loss[i]), float(one), **TOL)
        for g, want in zip(grads, torch.autograd.grad(one, tree_leaves(ad)),
                           strict=True):
            np.testing.assert_allclose(g[i].numpy(), want.numpy(), rtol=0,
                                       atol=2e-5 * float(want.abs().max()))


def test_lm_driver_one_step_vmap_equals_loop():
    kw = dict(arch=ARCH, reduced=True, clients=2, rounds=1, local_steps=1,
              batch=2, seq=16, verbose=False, device="cpu")
    vm = train.run(client_parallelism="vmap", **kw)
    lp = train.run(client_parallelism="loop", **kw)
    assert np.isfinite(vm["history"][0]["loss"])
    np.testing.assert_allclose(vm["history"][0]["loss"],
                               lp["history"][0]["loss"], rtol=1e-5)


def test_decode_matches_forward_across_the_ring():
    """24 tokens over a 16-slot window: the swa ring wraps, the rglru
    state carries (conv tail, h); logits at 2e-3 of the forward's."""
    cfg = get_config(ARCH).reduced(window=16)
    params = model.init_params(cfg, torch.Generator().manual_seed(7))
    b, t = 2, 24
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32))
    with torch.no_grad():
        want, _ = model.forward(cfg, params["base"], params["adapter"],
                                {"tokens": toks})
        cache = model.init_decode_cache(cfg, b, t, device="cpu")
        st = cache["groups"]["0"]
        assert st["conv"].shape == (1, b, cfg.conv1d_width - 1, cfg.rnn_d)
        assert st["h"].dtype == torch.float32
        got = []
        for step in range(t):
            lg, cache = model.decode_step(
                cfg, params["base"], params["adapter"], cache,
                {"token": toks[:, step:step + 1],
                 "positions": torch.full((b, 1), step, dtype=torch.int32)})
            got.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               rtol=2e-3, atol=2e-3)
    out = serve.generate(cfg, params, toks[:, :8], 4, device="cpu")
    assert out.shape == (b, 12)


def test_grouped_banks_refuse_rglru_blocks():
    """As in the JAX package, ServeEngine serves attention stacks only."""
    cfg = get_config(ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    base = model.init_params(cfg, gen)["base"]
    with pytest.raises(NotImplementedError, match="generate"):
        serve.ServeEngine(cfg, base, random_bank(cfg, 2, gen), slots=2,
                          device="cpu")


def test_flash_head_dims_are_the_kernel_instantiations():
    """``ops.HEAD_DIMS`` is the head-dim dispatch of flash_attention.cu
    (both dtypes), 256 among them; a head dim outside it is refused."""
    text = build.sources()["flash_attention"].read_text()
    for dtype in (0, 1):
        dims = tuple(int(d) for d in re.findall(
            rf"dtype == {dtype} && hd == (\d+)", text))
        assert dims == fa_ops.HEAD_DIMS
    assert 256 in fa_ops.HEAD_DIMS and 96 not in fa_ops.HEAD_DIMS
    q = torch.zeros((1, 8, 10, 256))
    k = torch.zeros((1, 8, 1, 256))
    fa_ops._check_operands(q, k, k, 2048)
    with pytest.raises(ValueError, match="head_dim 96"):
        fa_ops._check_operands(q[..., :96], k[..., :96], k[..., :96], 0)


def test_param_trees_match_jax_key_for_key():
    """The port's init and the converted JAX tree have the same key paths,
    shapes and dtypes (the f32 Λ among bf16 weights), and so have the
    decode caches."""
    jcfg = jget_config(ARCH).reduced(param_dtype="bfloat16")
    cfg = get_config(ARCH).reduced(param_dtype="bfloat16")
    want = convert.params_from_numpy(jax.tree.map(
        np.asarray, jmodel.init_params(jcfg, jax.random.key(0))), "cpu")
    got = model.init_params(cfg, torch.Generator().manual_seed(0))

    def flat(tree):
        return {jax.tree_util.keystr(p): (tuple(t.shape), t.dtype)
                for p, t in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(want) == flat(got)
    assert want["base"]["groups"]["0"]["rec"]["lam"].dtype == torch.float32
    jcache = convert.params_from_numpy(jax.tree.map(
        np.asarray, jmodel.init_decode_cache(jcfg, 2, 40)), "cpu")
    assert flat(jcache) == flat(model.init_decode_cache(cfg, 2, 40,
                                                        device="cpu"))
