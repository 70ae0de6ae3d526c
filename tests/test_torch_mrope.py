"""The port's M-RoPE and VLM path (qwen2-vl-72b) on the CPU, at reduced
size (2 layers, d 256, 4 / 2 heads of 64, M-RoPE sections (8, 12, 12), 16
vision patches), f32.

Positions are Qwen2-VL triplets, not one ``arange`` broadcast to (t, h, w)
(which is plain RoPE and cannot catch a wrong section split): P patches
are a √P × √P grid at t = 0, h = row, w = col, and the text continues at
the grid's largest id + 1 with t = h = w (``vlm_positions``).

The same seeded numpy inputs go through the JAX package and the port, the
params drawn by the port and moved across, every adapter off its
zero-delta init:

* ``apply_rope(sections=)`` at hd 64 (8, 12, 12) and hd 128 (16, 24, 24)
  against JAX's, within 2e-5; with t = h = w it is plain RoPE, bit for bit;
* ``forward``, ``loss_fn`` (with the vision prefix, over the text
  positions only) within 2e-5 of the largest entry, the adapter gradients
  within 2e-4 of each leaf's own largest entry (test_torch_enc_dec.py
  says why);
* ``decode_step`` on distinct (t, h, w) positions against JAX's;
* the step factories: ``make_train_step`` with microbatches 2 against 1
  and against the JAX step (``vision`` and the 3-D ``positions`` split
  along the batch), ``make_prefill_step`` and ``make_serve_step``;
* ``generate`` (text positions (t, t, t)) and ``ServeEngine`` against the
  JAX package's tokens, and ``ServeEngine`` against ``serve_naive``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adapter_bank as jbank_mod
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.config import get_config as jget_config
from repro_torch import convert
from repro_torch.core.adapter_bank import random_bank
from repro_torch.launch import serve, steps
from repro_torch.models import layers, model
from repro_torch.models.config import get_config
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "qwen2-vl-72b"
REL = 2e-5
GRAD_TOL = 2e-4
B, S = 2, 12


def _rel_close(got, want, tol=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _grad_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= GRAD_TOL * np.abs(want).max(), f"{what}: {err}"


def _paths(tree):
    return tree_leaves(tree_map_with_path(
        lambda p, _: "/".join(map(str, p)), tree))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def vlm_positions(b: int, patches: int, text: int) -> np.ndarray:
    """(b, patches + text, 3) int32 Qwen2-VL position ids: the patches a
    √P × √P grid at t = 0, h = row, w = col; the text from the grid's
    largest id + 1 on, t = h = w."""
    side = math.isqrt(patches)
    assert side * side == patches
    grid = np.stack([np.zeros(patches, np.int64),
                     np.arange(patches) // side,
                     np.arange(patches) % side], -1)
    start = grid.max() + 1 if patches else 0
    t = np.arange(start, start + text)
    pos = np.concatenate([grid, np.stack([t, t, t], -1)])
    return np.broadcast_to(pos[None], (b,) + pos.shape).astype(np.int32).copy()


def test_vlm_positions_are_qwen2_vl_triplets():
    pos = vlm_positions(1, 256, 4)[0]
    assert pos.shape == (260, 3)
    assert pos[17].tolist() == [0, 1, 1] and pos[255].tolist() == [0, 15, 15]
    assert pos[256:].tolist() == [[16, 16, 16], [17, 17, 17], [18, 18, 18],
                                  [19, 19, 19]]
    assert vlm_positions(1, 16, 1)[0, 16].tolist() == [4, 4, 4]


@pytest.mark.parametrize("hd,sections,patches", [(64, (8, 12, 12), 16),
                                                 (128, (16, 24, 24), 256)])
def test_apply_rope_sections_match_jax(hd, sections, patches):
    cfg = get_config(ARCH)
    assert cfg.reduced().mrope_sections == jget_config(
        ARCH).reduced().mrope_sections == (8, 12, 12)
    rng = np.random.default_rng(hd)
    pos = vlm_positions(2, patches, 20)
    x = rng.standard_normal((2, pos.shape[1], 3, hd)).astype(np.float32)
    theta = cfg.rope_theta
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                              sections=sections)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta, sections=sections)
    _rel_close(got, want, what="M-RoPE")
    # the split matters on these positions: t-only rope differs ...
    plain = layers.apply_rope(torch.from_numpy(x),
                              torch.from_numpy(pos[..., 0]), theta)
    assert float((plain - got).abs().max()) > 0.1
    # ... and with t = h = w it is plain RoPE, bit for bit
    same = np.repeat(pos[..., :1], 3, -1)
    assert torch.equal(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(same), theta,
                          sections=sections), plain)


def _batch(cfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "positions": vlm_positions(b, cfg.vision_patches, S),
            "vision": rng.standard_normal(
                (b, cfg.vision_patches, cfg.d_model)).astype(np.float32)}


@pytest.fixture(scope="module")
def v():
    """The reduced configs, params as numpy for both packages (drawn by
    the port, adapters off zero), the port's copy, one batch, the JAX
    package's jitted decode step."""
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    params = tree_map(lambda t: t.numpy(), model.init_params(
        cfg, torch.Generator().manual_seed(11)))
    rng = np.random.default_rng(12)
    params["adapter"] = tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        params["adapter"])
    params = jax.tree.map(np.asarray, params)
    jdecode = jax.jit(lambda p, c, x: jmodel.decode_step(
        jcfg, p["base"], p["adapter"], c, x))
    return dict(jcfg=jcfg, cfg=cfg, params=params,
                tp=convert.params_from_numpy(params, "cpu"),
                batch=_batch(cfg), jdecode=jdecode)


def test_forward_loss_and_grads_with_the_vision_prefix_match_jax(v):
    jcfg, cfg, params, tp, batch = (v[k] for k in ("jcfg", "cfg", "params",
                                                   "tp", "batch"))

    def jall(p, x):
        (l, m), g = jax.value_and_grad(
            lambda a: jmodel.loss_fn(jcfg, a, p["base"], x),
            has_aux=True)(p["adapter"])
        return jmodel.forward(jcfg, p["base"], p["adapter"], x)[0], l, m, g

    jlogits, jl, jm, jg = jax.jit(jall)(_jnp(params), _jnp(batch))
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    with torch.no_grad():
        logits, _ = model.forward(cfg, tp["base"], tp["adapter"], tb)
        hidden, _, n_prefix = model.forward_hidden(cfg, tp["base"],
                                                   tp["adapter"], tb)
    assert logits.shape == (B, S, cfg.vocab_size)       # the text only
    assert n_prefix == cfg.vision_patches and hidden.shape[1] == S + n_prefix
    _rel_close(logits, jlogits, what="forward logits")
    ad = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                  tp["adapter"])
    loss, met = model.loss_fn(cfg, ad, tp["base"], tb)
    grads = torch.autograd.grad(loss, tree_leaves(ad))
    _rel_close(float(loss.detach()), float(jl), what="loss")
    _rel_close(float(met["acc"]), float(jm["acc"]), what="acc")
    jgrads = dict(zip(_paths(jax.tree.map(np.asarray, jg)),
                      jax.tree.leaves(jg)))
    for path, g in zip(_paths(ad), grads, strict=True):
        _grad_close(g, jgrads[path], what=f"grad {path}")
    # the vision tokens and the triplets reach the loss
    with torch.no_grad():
        flat, _ = model.loss_fn(cfg, tp["adapter"], tp["base"], {
            **tb, "positions": tb["positions"][..., :1].expand(-1, -1, 3)})
    assert abs(float(flat) - float(loss.detach())) > 1e-4


def test_decode_on_triplets_matches_jax(v):
    """One-token decode with distinct (t, h, w) positions, against JAX's
    decode_step and, through the serve steps, the step factories."""
    jcfg, cfg, params, tp = v["jcfg"], v["cfg"], v["params"], v["tp"]
    toks = v["batch"]["tokens"]
    pos = vlm_positions(B, 4, 6)                       # a 2 x 2 grid, text
    cache = model.init_decode_cache(cfg, B, 16, device="cpu")
    jcache = _jnp(tree_map(lambda t: t.numpy().copy(), cache))
    jp = _jnp(params)
    serve_step, jserve_step = steps.make_serve_step(cfg), jax.jit(
        jsteps.make_serve_step(jcfg))
    scache = model.init_decode_cache(cfg, B, 16, device="cpu")
    sjcache = _jnp(tree_map(lambda t: t.numpy().copy(), scache))
    with torch.no_grad():
        for t in range(pos.shape[1]):
            x = {"token": toks[:, t:t + 1], "positions": pos[:, t:t + 1]}
            lg, cache = model.decode_step(
                cfg, tp["base"], tp["adapter"], cache,
                {k: torch.from_numpy(a) for k, a in x.items()})
            jlg, jcache = v["jdecode"](jp, jcache, _jnp(x))
            _rel_close(lg, jlg, what=f"decode {t}")
            sl, scache = serve_step(tp, scache, x)
            sjl, sjcache = jserve_step(jp, sjcache, _jnp(x))
            assert sl.shape == (B, cfg.padded_vocab)
            _rel_close(sl[:, :cfg.vocab_size],
                       np.asarray(sjl)[:, :cfg.vocab_size], what=f"serve {t}")


def test_prefill_step_matches_jax(v):
    jcfg, cfg, params, tp = v["jcfg"], v["cfg"], v["params"], v["tp"]
    batch = {k: x for k, x in v["batch"].items() if k != "labels"}
    want = jsteps.make_prefill_step(jcfg)(_jnp(params), _jnp(batch))
    got = steps.make_prefill_step(cfg)(tp, batch)
    assert got.shape == (B, cfg.padded_vocab)
    _rel_close(got[:, :cfg.vocab_size], np.asarray(want)[:, :cfg.vocab_size],
               what="prefill")


def test_train_step_microbatches_and_jax(v):
    jcfg, cfg, params, tp = v["jcfg"], v["cfg"], v["params"], v["tp"]
    batch = _batch(cfg, seed=13, b=4)
    js = jsteps.make_train_step(jcfg, lr=1e-3, microbatches=2)
    jp = _jnp(params)
    jp2, jo2, jm = jax.jit(js)(jp, js.optimizer.init(jp["adapter"]),
                              _jnp(batch))
    runs = {}
    for k in (1, 2):
        st = steps.make_train_step(cfg, lr=1e-3, microbatches=k)
        runs[k] = st(tp, st.optimizer.init(tp["adapter"]), batch)
    (p1, _, m1), (p2, o2, m2) = runs[1], runs[2]
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(p1["adapter"]), tree_leaves(p2["adapter"]),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
    assert set(m2) == set(jm)
    for k in m2:
        _rel_close(float(m2[k]), float(jm[k]), what=k)
    for mu, jmu in zip(tree_leaves(o2["mu"]), jax.tree.leaves(jo2["mu"]),
                       strict=True):
        _grad_close(10 * mu.numpy(), 10 * np.asarray(jmu), what="gradient")
    for a, b, m in zip(tree_leaves(p2["adapter"]),
                       jax.tree.leaves(jp2["adapter"]),
                       jax.tree.leaves(jo2["mu"]), strict=True):
        # as in test_torch_enc_dec.py: AdamW's first step maps round-off of
        # a gradient below 1e-4 of the leaf's largest to within ±lr
        a, b, m = a.numpy(), np.asarray(b), np.abs(np.asarray(m))
        big = m > 1e-4 * m.max()
        np.testing.assert_allclose(a[big], b[big], rtol=2e-4, atol=2e-5)
        assert np.abs(a - b).max() <= 2e-3


def test_generate_and_serve_engine_match_jax(v):
    jcfg, cfg, params, tp = v["jcfg"], v["cfg"], v["params"], v["tp"]
    prompts = np.random.default_rng(14).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(jserve.generate(jcfg, _jnp(params),
                                      jnp.asarray(prompts), 6))
    got = serve.generate(cfg, tp, prompts, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)

    bank = random_bank(cfg, 3, torch.Generator().manual_seed(15))
    jbank = jbank_mod.AdapterBank(       # the same numbers (a JAX draw
        tree=_jnp(tree_map(lambda t: t.numpy(), bank.tree)),  # takes ~5 s)
        n_clients=bank.n_clients, rank=bank.rank, users=dict(bank.users))
    reqs = jserve.make_requests(jbank, 4, prompt_len=6, gen=6,
                                vocab=jcfg.vocab_size, seed=16)
    jax_tokens = jserve.ServeEngine(jcfg, _jnp(params["base"]), jbank,
                                    slots=2, max_len=12).run(reqs)
    eng = serve.ServeEngine(cfg, tp["base"], bank, slots=2, max_len=12,
                            device="cpu")
    got = eng.run(reqs)
    naive = serve.serve_naive(cfg, tp["base"], bank, reqs, device="cpu")
    for want, what in ((jax_tokens, "JAX engine"), (naive, "serve_naive")):
        assert set(got) == set(want) == {r.rid for r in reqs}
        for r in reqs:
            np.testing.assert_array_equal(got[r.rid], want[r.rid],
                                          err_msg=f"{what}: rid={r.rid}")
