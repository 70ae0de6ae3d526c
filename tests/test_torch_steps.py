"""The port's launch step factories (``repro_torch.launch.steps``), its
activation checkpointing (``cfg.remat`` in ``transformer.run_stack``) and
its chunked loss (``model.loss_fn`` above S·V = 2^28), on the CPU.

* ``remat``: loss and adapter gradients with ``remat`` on and off are
  bitwise equal (tiny config and a reduced h2o-danube with ``swa``
  blocks, one client and stacked clients through ``adapter_rows``), and
  match the JAX ``loss_fn`` at f32 2e-5.
* The chunked loss (both packages' thresholds patched low, 1,024 tokens
  in two chunks) matches the JAX package's and the port's own unchunked
  loss.
* ``make_train_step``: microbatches 4 against 1 as ``tests/test_steps.py``
  holds the JAX package (loss rtol 1e-5, adapters rtol 2e-4 / atol 2e-5),
  and microbatches 2 against the JAX step (loss, metrics, AdamW's first
  moment — 0.1 × the gradients — and the updated adapters).
* Prefill and serve steps, ``shape_variant``, ``input_specs`` and
  ``abstract_cache`` against the JAX package's shapes (the mrope and
  enc-dec branches through ``with_overrides``), ``attn_impl=None``
  deferring to the config.
* The pod-axis federated round step (``make_fed_round_step``, 2 pods, the
  f32 and the bf16 C payload) against the JAX step, and the pod-stacked
  stand-ins against the JAX helpers' shapes.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JConfig
from repro.models.config import get_config as jget_config
from repro_torch import convert
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps
from repro_torch.models import attention, model
from repro_torch.models.config import ModelConfig, get_config
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
F32 = dict(rtol=2e-5, atol=2e-5)


def _params(cfg, seed=0):
    """Params as numpy for both packages (drawn by the port: the same
    arrays go through each), B and C moved off their zero-delta init so
    that every adapter factor carries a gradient."""
    params = tree_map(lambda t: t.numpy(), model.init_params(
        cfg, torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed + 1)
    params["adapter"] = tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        params["adapter"])
    return jax.tree.map(np.asarray, params)     # dict keys in JAX's order


@pytest.fixture(scope="module")
def jparams():
    """The tiny config's params, shared by the tests against JAX."""
    return _params(ModelConfig(**TINY))


def _batch(vocab, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _port_loss(cfg, params, batch, rows=None):
    base = convert.params_from_numpy(params["base"], "cpu")
    ad = tree_map(lambda t: t.requires_grad_(True),
                  convert.params_from_numpy(params["adapter"], "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = model.loss_fn(cfg, ad, base, tb, adapter_rows=rows)
    total = loss.sum()
    return total.detach(), torch.autograd.grad(total, tree_leaves(ad))


def _jax_loss(jcfg, params, batch):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda a, b, x: jmodel.loss_fn(jcfg, a, b, x), has_aux=True))(
        *(jax.tree.map(jnp.asarray, t)
          for t in (params["adapter"], params["base"], batch)))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------

_REMAT_CFGS = {
    "tiny": ModelConfig(**TINY),
    "h2o_swa": get_config("h2o-danube-3-4b").reduced(attn_impl="flash")}


@pytest.mark.parametrize("stacked", [False, True], ids=["loop", "rows"])
@pytest.mark.parametrize("arch", ["tiny", "h2o_swa"])
def test_remat_is_bitwise_no_remat(arch, stacked):
    """``remat`` recomputes each layer group's forward in the backward; the
    kernels' plain versions are repeatable, so loss and adapter gradients
    are bitwise the same as with every activation kept (and nothing is
    recomputed under ``no_grad``)."""
    cfg = _REMAT_CFGS[arch]
    params = _params(cfg)
    # 96 tokens: past the reduced h2o's 64-token window
    batch = _batch(cfg.vocab_size, 4 if stacked else 2, 96)
    rows = None
    if stacked:               # two clients of two sequences each
        params = dict(params, adapter=tree_map(
            lambda a: np.stack([a, a[::-1].copy() * 0.5]),
            params["adapter"]))
        rows = model.client_rows(2, 2, "cpu")
    assert cfg.remat
    on = _port_loss(cfg, params, batch, rows)
    off = _port_loss(cfg.with_overrides(remat=False), params, batch, rows)
    assert torch.equal(on[0], off[0])
    assert len(on[1]) == len(off[1]) > 0
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a, b)


def test_remat_checkpoints_each_group_only_under_grad(monkeypatch):
    """One checkpoint per layer group while autograd records; none in
    eval, none with ``remat=False``, and none for the tail blocks."""
    from repro_torch.models import transformer

    calls = []
    real = transformer.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", spy)
    cfg = ModelConfig(**{**TINY, "n_layers": 3,
                         "layer_pattern": ("attn", "attn")})
    assert cfg.stack_plan()[0] == 1 and len(cfg.stack_plan()[2]) == 1
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    ad = tree_map(lambda t: t.requires_grad_(True), params["adapter"])
    tb = {k: torch.from_numpy(v) for k, v in _batch(256, 1, 8).items()}
    loss, _ = model.loss_fn(cfg, ad, params["base"], tb)
    assert calls == [False]                 # the one group; the tail bare
    torch.autograd.grad(loss, tree_leaves(ad))
    calls.clear()
    with torch.no_grad():
        model.loss_fn(cfg, ad, params["base"], tb)
    model.loss_fn(cfg.with_overrides(remat=False), ad, params["base"], tb)
    assert calls == []


def test_remat_matches_jax_loss_and_grads(jparams):
    jcfg = JConfig(**TINY)
    assert jcfg.remat
    params = jparams
    batch = _batch(TINY["vocab_size"], 2, 32, seed=1)
    jloss, jgrads = _jax_loss(jcfg, params, batch)
    loss, grads = _port_loss(ModelConfig(**TINY), params, batch)
    np.testing.assert_allclose(float(loss), jloss, **F32)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, **F32)


# ---------------------------------------------------------------------------
# the chunked loss
# ---------------------------------------------------------------------------

def test_chunked_loss_matches_jax(monkeypatch, jparams):
    """1,024 tokens at vocab 256 with both thresholds patched to 2^17: the
    loss runs in two 512-token checkpointed chunks in both packages."""
    monkeypatch.setattr(jmodel, "_CE_CHUNK_THRESHOLD", 2 ** 17)
    monkeypatch.setattr(model, "_CE_CHUNK_THRESHOLD", 2 ** 17)
    chunks = []
    real = model._ce_terms

    def spy(cfg, hidden, *a):
        chunks.append(hidden.shape[1])
        return real(cfg, hidden, *a)

    monkeypatch.setattr(model, "_ce_terms", spy)
    jcfg = JConfig(**TINY)
    params = jparams
    batch = _batch(TINY["vocab_size"], 1, 1024, seed=2)
    batch["labels"][0, :100] = -1                   # ignored positions
    jloss, jgrads = _jax_loss(jcfg, params, batch)
    cfg = ModelConfig(**TINY)
    loss, grads = _port_loss(cfg, params, batch)
    # two chunks in the forward, each again in the backward's recompute
    assert chunks == [512] * 4
    np.testing.assert_allclose(float(loss), jloss, **F32)
    for g, jg in zip(grads, jgrads, strict=True):
        np.testing.assert_allclose(g.numpy(), jg, **F32)
    chunks.clear()
    monkeypatch.setattr(model, "_CE_CHUNK_THRESHOLD", 2 ** 28)
    whole, whole_grads = _port_loss(cfg, params, batch)
    assert chunks == [1024]
    np.testing.assert_allclose(float(whole), float(loss), rtol=1e-6)
    for a, b in zip(grads, whole_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

def test_microbatch_grad_accumulation_matches_full_batch():
    """k-microbatch gradient accumulation == the full-batch step, held as
    the JAX package's own test holds its step."""
    cfg = get_config("fed-100m").reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg.vocab_size, 8, 32)
    s1 = steps.make_train_step(cfg, lr=1e-3, microbatches=1)
    s4 = steps.make_train_step(cfg, lr=1e-3, microbatches=4)
    p1, _, m1 = s1(params, s1.optimizer.init(params["adapter"]), batch)
    p4, _, m4 = s4(params, s4.optimizer.init(params["adapter"]), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    assert set(m4) == {"loss", "ce", "aux", "acc"}
    for a, b in zip(tree_leaves(p1["adapter"]), tree_leaves(p4["adapter"]),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
    _, _, g4 = steps.loss_and_grads(cfg, params, batch, microbatches=4)
    assert all(g.dtype == torch.float32 for g in tree_leaves(g4))


def test_train_step_matches_jax_at_two_microbatches(jparams):
    jcfg = JConfig(**TINY)
    params = jparams
    batch = _batch(TINY["vocab_size"], 4, 16, seed=3)
    js = jsteps.make_train_step(jcfg, lr=1e-3, microbatches=2)
    jp = jax.tree.map(jnp.asarray, params)
    jp2, jo2, jm = jax.jit(js)(jp, js.optimizer.init(jp["adapter"]),
                              jax.tree.map(jnp.asarray, batch))
    st = steps.make_train_step(ModelConfig(**TINY), lr=1e-3, microbatches=2)
    tp = convert.params_from_numpy(params, "cpu")
    p2, o2, m = st(tp, st.optimizer.init(tp["adapter"]), batch)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **F32)
    assert o2["step"] == int(jo2["step"]) == 1
    for mu, jmu in zip(tree_leaves(o2["mu"]), jax.tree.leaves(jo2["mu"]),
                       strict=True):
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **F32)
    for a, b in zip(tree_leaves(p2["adapter"]),
                    jax.tree.leaves(jp2["adapter"]), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    assert p2["base"] is tp["base"]


# ---------------------------------------------------------------------------
# prefill, serve, shapes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = get_config("fed-100m").reduced()
    return cfg, model.init_params(cfg, torch.Generator().manual_seed(0))


def test_prefill_step_last_logits(small):
    cfg, params = small
    batch = _batch(cfg.vocab_size, 8, 32)
    logits = steps.make_prefill_step(cfg)(params,
                                          {"tokens": batch["tokens"]})
    assert logits.shape == (8, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
    full, _ = model.forward(cfg, params["base"], params["adapter"],
                            {"tokens": torch.from_numpy(batch["tokens"])})
    np.testing.assert_allclose(logits[:, :cfg.vocab_size].numpy(),
                               full[:, -1].detach().numpy(), **F32)


def test_serve_step_roundtrip(small):
    cfg, params = small
    serve = steps.make_serve_step(cfg)
    cache = model.init_decode_cache(cfg, 2, 16, device="cpu")
    batch = {"token": np.ones((2, 1), np.int32),
             "positions": np.zeros((2, 1), np.int32)}
    logits, cache2 = serve(params, cache, batch)
    assert logits.shape == (2, cfg.padded_vocab)
    assert int(cache2["groups"]["0"]["idx"][0]) == 1       # cache advanced
    logits2, cache3 = serve(params, cache2, {"token": np.ones((2, 1),
                                                              np.int32),
                                             "positions": np.ones((2, 1),
                                                                  np.int32)})
    assert int(cache3["groups"]["0"]["idx"][0]) == 2
    assert not torch.equal(logits, logits2)


def test_shape_variant_long500k():
    cfg = get_config("qwen2.5-14b")
    v = steps.shape_variant(cfg, "long_500k")
    assert v.layer_pattern == ("swa",)
    assert v.window == steps.SWA_VARIANT_WINDOW
    assert dataclasses.asdict(v) == dataclasses.asdict(jsteps.shape_variant(
        jget_config("qwen2.5-14b"), "long_500k"))
    assert steps.shape_variant(cfg, "train_4k") is cfg
    # natively sub-quadratic archs unchanged
    for arch in ("rwkv6-1.6b", "h2o-danube-3-4b"):
        c = get_config(arch)
        assert steps.shape_variant(c, "long_500k") is c


_MODALITIES = {
    "text": {},
    "mrope": dict(pos_type="mrope", vision_patches=64),
    "enc_dec": dict(enc_dec=True, n_enc_layers=2, pos_type="learned"),
}


@pytest.mark.parametrize("shape", sorted(jsteps.SHAPES))
@pytest.mark.parametrize("modality", sorted(_MODALITIES))
def test_input_specs_match_jax(modality, shape):
    over = _MODALITIES[modality]
    cfg = get_config("qwen2.5-14b").with_overrides(**over)
    jcfg = jget_config("qwen2.5-14b").with_overrides(**over)
    spec, jspec = steps.input_specs(cfg, shape), jsteps.input_specs(jcfg,
                                                                    shape)
    assert spec.keys() == jspec.keys()
    for k, t in spec.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jspec[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(jspec[k].dtype), k
    if modality == "mrope" and shape == "train_4k":
        assert "vision" in spec and spec["positions"].shape[-1] == 3
    if modality == "enc_dec" and shape == "prefill_32k":
        assert spec["frames"].shape[1] == 1500


@pytest.mark.parametrize("arch,shape", [("h2o-danube-3-4b", "decode_32k"),
                                        ("qwen2.5-14b", "long_500k"),
                                        ("rwkv6-1.6b", "decode_32k"),
                                        ("whisper-small", "decode_32k"),
                                        ("qwen2-vl-72b", "decode_32k")])
def test_abstract_cache_matches_jax(arch, shape):
    cfg = steps.shape_variant(get_config(arch), shape)
    jcfg = jsteps.shape_variant(jget_config(arch), shape)
    cache = steps.abstract_cache(cfg, shape)
    jcache = jsteps.abstract_cache(jcfg, shape)
    got = [(tuple(t.shape), str(t.dtype).split(".")[-1], t.device.type)
           for t in tree_leaves(cache)]
    want = [(tuple(t.shape), str(t.dtype), "meta")
            for t in jax.tree.leaves(jcache)]
    assert sorted(got) == sorted(want)
    if arch == "h2o-danube-3-4b":       # the full 4,096-slot ring
        assert cache["groups"]["0"]["k"].shape == (24, 128, 4096, 8, 120)
    if arch == "whisper-small":         # the cross K/V of 1,500 frames
        assert cache["groups"]["0"]["xk"].shape == (12, 128, 1500, 12, 64)


def test_steps_default_attn_impl_from_config(monkeypatch):
    """The factories pass attn_impl=None down the stack, so the attention
    layer resolves the backend from ModelConfig.attn_impl."""
    seen = []
    orig = attention.select_impl

    def spy(cfg, seq_len, **kw):
        out = orig(cfg, seq_len, **kw)
        seen.append((kw.get("impl"), out))
        return out

    monkeypatch.setattr(attention, "select_impl", spy)
    cfg = ModelConfig(**TINY).with_overrides(attn_impl="blockwise")
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg.vocab_size, 2, 16)
    step = steps.make_train_step(cfg, lr=1e-3)
    step(params, step.optimizer.init(params["adapter"]), batch)
    assert seen and all(received is None for received, _ in seen)
    assert all(resolved == "blockwise" for _, resolved in seen)
    seen.clear()
    steps.make_prefill_step(cfg)(params, {"tokens": batch["tokens"]})
    assert seen and all(s == (None, "blockwise") for s in seen)
    seen.clear()
    step = steps.make_train_step(cfg, lr=1e-3, attn_impl="ref")
    step(params, step.optimizer.init(params["adapter"]), batch)
    assert seen and all(s == ("ref", "ref") for s in seen)


@pytest.mark.parametrize("factory", ["make_fed_round_step",
                                     "pod_stacked_adapter",
                                     "pod_stacked_opt_state"])
def test_fed_round_factories_are_not_ported(factory):
    """The pod-axis factories (they raised until the mesh layer was
    ported): the step reads its pod count from the mesh, and the
    pod-stacked stand-ins are on ``meta`` with the JAX helpers' shapes and
    dtypes (the optimizer's step count is a host int in the port)."""
    cfg, jcfg = ModelConfig(**TINY), JConfig(**TINY)
    mesh = pmesh.make_production_mesh(multi_pod=True)
    step = steps.make_fed_round_step(cfg, mesh)
    if factory == "make_fed_round_step":
        assert step.n_pods == 2
        assert jsteps.make_fed_round_step(
            jcfg, types.SimpleNamespace(shape={"pod": 2})).n_pods == 2
        return
    if factory == "pod_stacked_adapter":
        got = steps.pod_stacked_adapter(cfg, 2)
        want = jsteps.pod_stacked_adapter(jcfg, 2)
    else:
        got = steps.pod_stacked_opt_state(cfg, 2, step.optimizer)
        want = jsteps.pod_stacked_opt_state(
            jcfg, 2, jsteps.make_fed_round_step(
                jcfg, types.SimpleNamespace(shape={"pod": 2})).optimizer)
        assert got["step"] == 0 and want["step"].shape == (2,)
        got, want = dict(got, step=None), dict(want, step=None)
    leaves = jax.tree.leaves(got)         # dict keys in JAX's order
    assert all(t.device.type == "meta" for t in leaves)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in leaves] \
        == [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(want)]


@pytest.fixture(scope="module")
def fed_inputs(jparams):
    """Two pods' adapters (pod 1's moved off pod 0's), a batch of 2 × 2
    sequences and personalized weights W."""
    rng = np.random.default_rng(7)
    ad_p = jax.tree.map(lambda a: np.stack([a, (a + 0.05 * rng.standard_normal(
        a.shape)).astype(a.dtype)]), jparams["adapter"])
    w = np.asarray([[0.7, 0.3], [0.4, 0.6]], np.float32)
    return ad_p, _batch(TINY["vocab_size"], 4, 16, seed=3), w


@pytest.mark.parametrize("payload", [None, "bfloat16"])
def test_fed_round_step_matches_jax(jparams, fed_inputs, payload):
    """``make_fed_round_step`` at 2 pods against the JAX step (run under a
    one-device ("pod", "data", "model") mesh with a 2-pod stand-in):
    losses, the pod-stacked adapters (A / B pod-local, C̄ = W·C) and the
    AdamW moments at f32 2e-5, with the f32 and the bf16 C payload."""
    ad_p, batch, w = fed_inputs
    jstep = jsteps.make_fed_round_step(
        JConfig(**TINY), types.SimpleNamespace(shape={"pod": 2}),
        payload_dtype=None if payload is None else jnp.bfloat16)
    with jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
                           ("pod", "data", "model")):
        jad, jos, jl = jax.jit(jstep)(jparams, ad_p,
                                      jax.vmap(jstep.optimizer.init)(ad_p),
                                      batch, w)
    step = steps.make_fed_round_step(
        ModelConfig(**TINY), pmesh.make_production_mesh(multi_pod=True),
        payload_dtype=None if payload is None else torch.bfloat16)
    pad = convert.params_from_numpy(ad_p, "cpu")
    ad, os_, losses = step(convert.params_from_numpy(jparams, "cpu"), pad,
                           step.optimizer.init(pad), batch, w)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), **F32)
    for got, want in ((ad, jad), (os_["mu"], jos["mu"]),
                      (os_["nu"], jos["nu"])):
        for g, j in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                        strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), **F32)
