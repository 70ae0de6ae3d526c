"""The port's Mixture-of-Experts block (``models/moe.py``) and the MoE
configs grok-1-314b and llama4-scout-17b-a16e, on the CPU.

The same seeded numpy inputs go through the JAX package and the port, f32,
at 2e-5 unless a test says otherwise: the router (dispatch equal exactly,
combine and the aux loss at 2e-5, with real capacity drops at the default
capacity factor 1.25); ``moe_mlp`` and its gradient with respect to x on
the padded path (S = 1100 in 1024-token groups) and on the chunked path
(``MOE_GROUP`` / ``MOE_CHUNK_TOKENS`` patched small in both packages); the
reduced configs' loss, ce, aux and adapter gradients (the gradients at 1e-4
of their largest entry, as the other model tests); under
``adapter_rows`` each client's aux equal to its own single run's and to the
JAX ``loss_fn`` on its batch; decode against the forward at 2e-3 (no drops:
``capacity_factor = n_experts``); one training step of the LM driver on
vmap and on loop; ``ServeEngine`` against ``serve_naive``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models.config import get_config as jget_config
from repro_torch import convert
from repro_torch.core import client_batch
from repro_torch.core.adapter_bank import random_bank
from repro_torch.launch import serve, train
from repro_torch.models import model, moe
from repro_torch.models.config import get_config, list_configs
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401

MOE = ("grok-1-314b", "llama4-scout-17b-a16e")
TOL = dict(rtol=2e-5, atol=2e-5)
#: adapter gradients through a whole model: 1e-4 of the largest entry, the
#: f32 gradient tolerance of the port's other model tests
#: (test_torch_configs.py); the two packages sum in other orders
GRAD_TOL = 1e-4


@pytest.mark.parametrize("name", MOE)
def test_config_fields_match_jax(name):
    assert name in list_configs()
    cfg = get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(name))
    assert cfg.is_moe and cfg.layer_pattern == ("attn",) and cfg.hd == 128


def _jax_params(jcfg, seed):
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jcfg, jax.random.key(seed)))
    # move B off zero so that every adapter factor carries a gradient
    rng = np.random.default_rng(seed + 1)
    params["adapter"] = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        params["adapter"])
    return params


def _moe_params(name, seed):
    """One reduced MoE layer's params (numpy) and both configs."""
    jcfg = jget_config(name).reduced()
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.key(seed), jcfg))
    return jcfg, get_config(name).reduced(), p


@pytest.mark.parametrize("name", MOE)
def test_route_matches_jax_with_drops(name):
    jcfg, cfg, p = _moe_params(name, 0)
    rng = np.random.default_rng(1)
    # a direction every token shares skews the router, as hidden states'
    # common component does: some experts overflow their capacity
    x = (rng.standard_normal((3, 64, cfg.d_model))
         + 2.0 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    jd, jc, jaux = jmoe.route(jcfg, jnp.asarray(p["router"]), jnp.asarray(x))
    d, c, aux = moe.route(cfg, torch.from_numpy(p["router"]),
                          torch.from_numpy(x))
    assert d.shape == (3, 64, cfg.n_experts, moe.capacity(cfg, 64))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # the capacity cut some tokens' picks: fewer slots than picks
    assert d.sum() < 3 * 64 * cfg.top_k
    assert cfg.top_k == (2 if name == "grok-1-314b" else 1)


def test_capacity_matches_jax():
    for name in MOE:
        cfg, jcfg = get_config(name).reduced(), jget_config(name).reduced()
        for seq in (1, 2, 7, 64, 1024, 1100):
            assert moe.capacity(cfg, seq) == jmoe.capacity(jcfg, seq)
    assert moe.MOE_GROUP == jmoe.MOE_GROUP
    assert moe.MOE_CHUNK_TOKENS == jmoe.MOE_CHUNK_TOKENS


#: (arch, B, S, (MOE_GROUP, MOE_CHUNK_TOKENS) patched or None): the padded
#: path (1100 = 1024 + 76 tokens, two groups a sequence) and the chunked
#: path (16-token groups, chunks of 2 groups, 4 chunks) at top-2 and top-1
MLP_CASES = [("grok-1-314b", 1, 1100, None),
             ("llama4-scout-17b-a16e", 2, 64, (16, 32)),
             ("grok-1-314b", 2, 60, (16, 32))]


@pytest.mark.parametrize("name,b,s,patch", MLP_CASES)
def test_moe_mlp_and_dx_match_jax(monkeypatch, name, b, s, patch):
    if patch:
        for mod in (moe, jmoe):
            monkeypatch.setattr(mod, "MOE_GROUP", patch[0])
            monkeypatch.setattr(mod, "MOE_CHUNK_TOKENS", patch[1])
    jcfg, cfg, p = _moe_params(name, 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    (jout, jaux), vjp = jax.vjp(lambda xx: jmoe.moe_mlp(jcfg, jp, xx),
                                jnp.asarray(x))
    (jdx,) = vjp((jnp.asarray(ct), jnp.zeros((), jnp.float32)))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_mlp(cfg, convert.params_from_numpy(p, "cpu"), tx)
    (dx,) = torch.autograd.grad(out, tx, torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    # by_row: each sequence's own aux, whose mean is the scalar
    _, rows = moe.moe_mlp(cfg, convert.params_from_numpy(p, "cpu"),
                          torch.from_numpy(x), by_row=True)
    assert rows.shape == (b,)
    np.testing.assert_allclose(float(rows.mean()), float(jaux), **TOL)
    for i in range(b):
        np.testing.assert_allclose(float(rows[i]), float(jmoe.moe_mlp(
            jcfg, jp, jnp.asarray(x[i:i + 1]))[1]), **TOL)


def _loss_inputs(name, seed, b, s):
    jcfg = jget_config(name).reduced()
    params = _jax_params(jcfg, seed)
    toks = np.random.default_rng(seed + 7).integers(
        0, jcfg.vocab_size, (b, s + 1)).astype(np.int32)
    return jcfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_loss(jcfg, params, batch):
    return jax.jit(jax.value_and_grad(
        lambda a, bb, x: jmodel.loss_fn(jcfg, a, bb, x), has_aux=True))(
        *(jax.tree.map(jnp.asarray, t)
          for t in (params["adapter"], params["base"], batch)))


@pytest.mark.parametrize("name", MOE)
def test_reduced_loss_aux_and_grads_match_jax(name):
    jcfg, params, batch = _loss_inputs(name, 4, 2, 40)
    (jloss, jm), jgrads = _jax_loss(jcfg, params, batch)
    cfg = get_config(name).reduced(attn_impl="flash")
    ad = tree_map(lambda t: t.requires_grad_(True),
                  convert.params_from_numpy(params["adapter"], "cpu"))
    base = convert.params_from_numpy(params["base"], "cpu")
    assert base["groups"]["0"]["moe"]["router"].dtype == torch.float32
    assert "mlp" not in base["groups"]["0"]
    loss, m = model.loss_fn(cfg, ad, base,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(ad))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for key in ("ce", "aux", "acc"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL)
    assert float(m["aux"]) > 0
    for g, jg in zip(grads, jax.tree.leaves(jgrads), strict=True):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=GRAD_TOL * max(1.0, np.abs(jg).max()))


def test_experts_take_no_adapter_even_with_lora_mlp():
    name = "grok-1-314b"
    jcfg = jget_config(name).reduced(lora_mlp=True)
    jad = jmodel.init_params(jcfg, jax.random.key(0))["adapter"]
    ad = model.init_params(get_config(name).reduced(lora_mlp=True),
                           torch.Generator().manual_seed(0))["adapter"]
    assert set(ad["groups"]["0"]) == set(jad["groups"]["0"]) == {"attn"}


@pytest.mark.parametrize("name", MOE)
def test_per_client_aux_under_adapter_rows(name):
    """Two clients of two sequences each plus one row of no client (-1),
    folded into one batch: loss, ce and aux are (m,) vectors, client i's
    equal to its own single run and to the JAX loss_fn on its batch."""
    m, b, s = 2, 2, 24
    jcfg, params, batch = _loss_inputs(name, 5, m * b + 1, s)
    cfg = get_config(name).reduced()
    base = convert.params_from_numpy(params["base"], "cpu")
    rng = np.random.default_rng(9)
    ads = [tree_map(lambda t: t + 0.05 * torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)),
        convert.params_from_numpy(params["adapter"], "cpu"))
        for _ in range(m)]
    rows = torch.tensor([0, 0, 1, 1, -1], dtype=torch.int32)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, met = model.loss_fn(cfg, client_batch.stack_states(ads), base,
                                  tb, adapter_rows=rows)
    assert loss.shape == met["aux"].shape == (m,)
    assert abs(float(met["aux"][0]) - float(met["aux"][1])) > 1e-6
    for i in range(m):
        own = {k: v[b * i:b * i + b] for k, v in tb.items()}
        with torch.no_grad():
            one, om = model.loss_fn(cfg, ads[i], base, own)
        np.testing.assert_allclose(float(loss[i]), float(one), **TOL)
        np.testing.assert_allclose(float(met["aux"][i]), float(om["aux"]),
                                   **TOL)
        jb = {k: v[b * i:b * i + b] for k, v in batch.items()}
        jl, jm = jmodel.loss_fn(
            jcfg, jax.tree.map(lambda t: jnp.asarray(t.numpy()), ads[i]),
            jax.tree.map(jnp.asarray, params["base"]),
            jax.tree.map(jnp.asarray, jb))
        np.testing.assert_allclose(float(loss[i]), float(jl), **TOL)
        np.testing.assert_allclose(float(met["aux"][i]), float(jm["aux"]),
                                   **TOL)


@pytest.mark.parametrize("name", MOE)
def test_decode_matches_forward(name):
    """Token-by-token decode (capacity 1 a token) against the forward's
    logits with no drops (capacity_factor = n_experts), at 2e-3."""
    cfg = get_config(name).reduced()
    cfg = cfg.with_overrides(capacity_factor=float(cfg.n_experts))
    params = model.init_params(cfg, torch.Generator().manual_seed(3))
    b, t = 2, 12
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32))
    with torch.no_grad():
        want, _ = model.forward(cfg, params["base"], params["adapter"],
                                {"tokens": toks})
        cache = model.init_decode_cache(cfg, b, 16, device="cpu")
        got = []
        for step in range(t):
            lg, cache = model.decode_step(
                cfg, params["base"], params["adapter"], cache,
                {"token": toks[:, step:step + 1],
                 "positions": torch.full((b, 1), step, dtype=torch.int32)})
            got.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_lm_driver_one_step_vmap_equals_loop():
    kw = dict(arch="llama4-scout-17b-a16e", reduced=True, clients=2,
              rounds=1, local_steps=1, batch=2, seq=16, verbose=False,
              device="cpu")
    vm = train.run(client_parallelism="vmap", **kw)
    lp = train.run(client_parallelism="loop", **kw)
    assert np.isfinite(vm["history"][0]["loss"])
    np.testing.assert_allclose(vm["history"][0]["loss"],
                               lp["history"][0]["loss"], rtol=1e-5)


def test_serve_engine_matches_naive():
    """grok-1 reduced, no drops in the prefill-free decode: ServeEngine's
    grouped decode (capacity 1 a token) gives serve_naive's tokens."""
    cfg = get_config("grok-1-314b").reduced()
    gen = torch.Generator().manual_seed(11)
    base = model.init_params(cfg, gen)["base"]
    bank = random_bank(cfg, 3, gen)
    reqs = serve.make_requests(bank, 4, prompt_len=6, gen=5,
                               vocab=cfg.vocab_size, seed=2)
    eng = serve.ServeEngine(cfg, base, bank, slots=2, max_len=11,
                            device="cpu")
    got = eng.run(reqs)
    want = serve.serve_naive(cfg, base, bank, reqs, device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid])


@pytest.mark.parametrize("name", MOE)
def test_param_trees_match_jax_key_for_key(name):
    """The port's init and the converted JAX tree have the same key paths,
    shapes and dtypes (the f32 router among bf16 experts)."""
    jcfg = jget_config(name).reduced(param_dtype="bfloat16")
    want = convert.params_from_numpy(jax.tree.map(
        np.asarray, jmodel.init_params(jcfg, jax.random.key(0))), "cpu")
    got = model.init_params(get_config(name).reduced(param_dtype="bfloat16"),
                            torch.Generator().manual_seed(0))
    flat = {jax.tree_util.keystr(p): (tuple(t.shape), t.dtype)
            for p, t in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat == {jax.tree_util.keystr(p): (tuple(t.shape), t.dtype)
                    for p, t in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert want["base"]["groups"]["0"]["moe"]["router"].dtype == torch.float32
    assert want["base"]["groups"]["0"]["moe"]["w_up"].dtype == torch.bfloat16
