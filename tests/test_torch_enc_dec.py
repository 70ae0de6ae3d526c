"""The port's encoder-decoder path (whisper-small) on the CPU, at reduced
size (2 + 2 layers, d 256, 4 MHA heads of 64, 16 frames), f32.

The same seeded numpy inputs go through the JAX package and the port, whose
params are the JAX ones moved across (``convert.params_from_numpy``), every
adapter off its zero-delta init (``xattn`` included):

* the param trees key for key (shapes and dtypes, the ``encoder`` subtree,
  ``ln_x`` / ``xattn`` and ``pos_embed``);
* the vectorized clients: two clients' batches under ``adapter_rows``
  against each client alone (port only);
* ``encode``, ``forward`` and ``loss_fn`` within 2e-5 of each tensor's
  largest entry, the adapter gradients within 2e-4 of each leaf's own
  largest entry (``GRAD_TOL``);
* cross-attention's tiled path: ``blockwise_sdpa(causal=False)`` over 1,500
  frames (five 256-frame tiles and a tail of 220) against the JAX
  package's padded version;
* ``decode_step`` with the cross cache filled from the encoder (the
  tests' own helper, as tests/test_decode_consistency.py keeps one):
  against JAX's, step for step, and both against the forward at 2e-3 with
  the ``xattn`` adapters at zero;
* the reference caveat: decode applies no ``xattn`` adapter where the
  forward does, so with them off zero decode parts from the forward — by
  the same amount in both packages;
* the step factories: ``make_train_step`` with microbatches 2 against 1
  (the JAX test's tolerances) and against the JAX step (``frames`` split
  along the batch), ``make_prefill_step`` and ``make_serve_step`` against
  JAX's;
* ``generate`` and ``ServeEngine`` (zero cross cache: the cross term is
  exactly zero, as in the JAX package) against the JAX package's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adapter_bank as jbank_mod
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import model as jmodel
from repro.models.config import get_config as jget_config
from repro_torch import convert
from repro_torch.core.adapter_bank import random_bank
from repro_torch.launch import serve, steps
from repro_torch.models import attention, model
from repro_torch.models.config import get_config
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-small"
#: f32 tolerance of every comparison with the JAX package, relative to
#: the tensor's largest entry
REL = 2e-5
#: adapter gradients through the whole model: within 2e-4 of each leaf's
#: own largest entry.  Relative to a leaf's own largest entry the JAX
#: package's f32 gradients sit up to 3.5e-5, and the port's up to 1.1e-4
#: (a cross-attention wk factor), from the same gradients evaluated in
#: float64, so 2e-5 would hold round-off; port and JAX part by up to
#: 1.13e-4 of a leaf's largest entry here
GRAD_TOL = 2e-4


def _grad_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= GRAD_TOL * np.abs(want).max(), f"{what}: {err}"
B, S = 2, 12


def _rel_close(got, want, tol=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _paths(tree):
    """The key path of every leaf, as 'a/b/0/c'."""
    return tree_leaves(tree_map_with_path(
        lambda p, _: "/".join(map(str, p)), tree))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "frames": rng.standard_normal(
                (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_bank(bank):
    """The JAX package's ``AdapterBank`` of the port's bank (the same
    numbers): drawing one in JAX takes ~5 s of eager dispatch."""
    return jbank_mod.AdapterBank(
        tree=_jnp(tree_map(lambda t: t.numpy(), bank.tree)),
        n_clients=bank.n_clients, rank=bank.rank, users=dict(bank.users))


@pytest.fixture(scope="module")
def w():
    """The reduced configs, params as numpy for both packages (drawn by
    the port, the adapters moved off their zero-delta init), the port's
    copy through ``convert``, one batch, and the JAX package's jitted
    forward (encode, logits) and decode step, shared by the tests."""
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    params = tree_map(lambda t: t.numpy(), model.init_params(
        cfg, torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(4)
    params["adapter"] = tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        params["adapter"])
    params = jax.tree.map(np.asarray, params)   # dict keys in JAX's order
    jfwd = jax.jit(lambda p, x: (
        jmodel.encode(jcfg, p["base"], x["frames"]),
        jmodel.forward(jcfg, p["base"], p["adapter"], x)[0]))
    jdecode = jax.jit(lambda p, c, x: jmodel.decode_step(
        jcfg, p["base"], p["adapter"], c, x))
    return dict(jcfg=jcfg, cfg=cfg, params=params,
                tp=convert.params_from_numpy(params, "cpu"),
                batch=_batch(cfg), jfwd=jfwd, jdecode=jdecode)


def _xattn_zero(params):
    """``params`` with every ``xattn`` adapter's B at zero (no delta)."""
    def z(path, a):
        return np.zeros_like(a) if "xattn" in path and path[-1] == "B" \
            else a        # path: the tuple of keys
    return {"base": params["base"],
            "adapter": tree_map_with_path(z, params["adapter"])}


def test_param_trees_match_key_for_key(w):
    cfg = w["cfg"]
    got = model.init_params(cfg, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: jmodel.init_params(w["jcfg"],
                                                     jax.random.key(0)))
    gp = dict(zip(_paths(got), tree_leaves(got)))
    wp = dict(zip(_paths(want), jax.tree.leaves(want)))
    assert gp.keys() == wp.keys()
    for k, t in gp.items():
        assert tuple(t.shape) == wp[k].shape, k
        assert str(t.dtype).split(".")[-1] == str(wp[k].dtype), k
    assert {"encoder", "pos_embed"} <= set(got["base"])
    assert set(got["base"]["encoder"]) == {"groups", "tail", "final_norm",
                                           "pos_embed"}
    blk = got["base"]["groups"]["0"]
    assert {"ln_x", "xattn"} <= set(blk)
    assert "xattn" not in got["base"]["encoder"]["groups"]["0"]
    assert set(got["adapter"]["groups"]["0"]) == {"attn", "xattn"}
    # the converted tree is the numpy tree, leaf for leaf
    np_leaves = dict(zip(_paths(w["params"]), tree_leaves(w["params"])))
    for k, t in zip(_paths(w["tp"]), tree_leaves(w["tp"])):
        np.testing.assert_array_equal(t.numpy(), np_leaves[k])


def test_encode_forward_loss_and_grads_match_jax(w):
    jcfg, cfg, params, tp = w["jcfg"], w["cfg"], w["params"], w["tp"]
    batch = w["batch"]
    jb = _jnp(batch)

    def jloss(a, b, x):
        return jmodel.loss_fn(jcfg, a, b, x)

    jenc, jlogits = w["jfwd"](_jnp(params), jb)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _jnp(params["adapter"]), _jnp(params["base"]), jb)
    tb = _torch_batch(batch)
    with torch.no_grad():
        enc = model.encode(cfg, tp["base"], tb["frames"])
        logits, _ = model.forward(cfg, tp["base"], tp["adapter"], tb)
    _rel_close(enc, jenc, what="encode")
    _rel_close(logits, jlogits, what="forward logits")
    ad = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                  tp["adapter"])
    loss, met = model.loss_fn(cfg, ad, tp["base"], tb)
    grads = torch.autograd.grad(loss, tree_leaves(ad))
    _rel_close(float(loss.detach()), float(jl), what="loss")
    for k in ("ce", "acc"):
        _rel_close(float(met[k].detach()), float(jm[k]), what=k)
    jgrads = dict(zip(_paths(jax.tree.map(np.asarray, jg)),
                      jax.tree.leaves(jg)))
    for path, g in zip(_paths(ad), grads, strict=True):
        _grad_close(g, jgrads[path], what=f"grad {path}")
    # the xattn adapters carry a gradient of their own
    assert any("/xattn/" in p and float(g.abs().max()) > 0
               for p, g in zip(_paths(ad), grads))


def test_adapter_rows_equal_each_client_alone(w):
    """Two clients' batches folded into one under ``adapter_rows`` (the
    vectorized clients): each client's loss and adapter gradients, the
    ``xattn`` ones included (its queries and its own encoder rows take its
    adapter), equal that client's run alone.  In float64, where the two
    orders of summation part by ~1e-15 (in f32 by up to ~2e-4 of a leaf's
    largest entry, round-off alone)."""
    cfg = w["cfg"]
    tp = tree_map(lambda t: t.double(), w["tp"])
    rng = np.random.default_rng(10)
    ads = [tp["adapter"], tree_map(lambda t: t + torch.from_numpy(
        0.05 * rng.standard_normal(tuple(t.shape))), tp["adapter"])]
    stacked = tree_map(lambda a, b: torch.stack([a, b]).requires_grad_(True),
                       *ads)
    batches = [_torch_batch(_batch(cfg, seed=11 + i)) for i in range(2)]
    for x in batches:
        x["frames"] = x["frames"].double()
    tb = {k: torch.cat([x[k] for x in batches]) for k in batches[0]}
    loss, _ = model.loss_fn(cfg, stacked, tp["base"], tb,
                            adapter_rows=model.client_rows(2, B, "cpu"))
    assert loss.shape == (2,)
    grads = torch.autograd.grad(loss.sum(), tree_leaves(stacked))
    assert any("/xattn/" in p for p in _paths(tp["adapter"]))
    for i in range(2):
        ad = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      ads[i])
        one, _ = model.loss_fn(cfg, ad, tp["base"], batches[i])
        _rel_close(float(loss[i].detach()), float(one.detach()), tol=1e-12,
                   what=f"client {i} loss")
        for path, g, want in zip(_paths(ad), grads, torch.autograd.grad(
                one, tree_leaves(ad)), strict=True):
            _rel_close(g[i], want, tol=1e-10, what=f"client {i} grad {path}")


def test_cross_blockwise_at_1500_frames_matches_jax():
    """Cross-attention's tiled path (above CROSS_TILE_THRESHOLD): 300
    decoder rows over 1,500 frames, bidirectional, against the JAX
    package's padded scan."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 300, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1500, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 1500, 2, 16)).astype(np.float32)
    want = jattention.blockwise_sdpa(*map(jnp.asarray, (q, k, v)),
                                     causal=False)
    got = attention.blockwise_sdpa(*map(torch.from_numpy, (q, k, v)),
                                   causal=False)
    _rel_close(got, want, what="blockwise cross")
    _rel_close(attention.sdpa(*map(torch.from_numpy, (q, k, v)),
                              causal=False), want, what="sdpa cross")
    cfg = get_config(ARCH)
    assert attention.select_impl(cfg.with_overrides(attn_impl="flash"), 4096,
                                 kv_len=1500) == "blockwise"
    assert attention.select_impl(cfg, 12, kv_len=1500) == "ref"


def _fill_cross_cache(cfg, base, cache, enc_out):
    """Every decoder block's ``xk`` / ``xv`` from the encoder's output
    (``enc_out @ xattn.wk / wv``, no adapter, no bias), in place: the
    port's copy of tests/test_decode_consistency.py's helper."""
    b = enc_out.shape[0]

    def kv(xp):
        return [(enc_out @ xp[n]).reshape(b, -1, cfg.n_heads, cfg.hd)
                for n in ("wk", "wv")]
    q, _, _ = cfg.stack_plan()
    for key, blk in (cache["groups"] or {}).items():
        for layer in range(q):
            xk, xv = kv({n: base["groups"][key]["xattn"][n][layer]
                         for n in ("wk", "wv")})
            blk["xk"][layer].copy_(xk)
            blk["xv"][layer].copy_(xv)
    for blk, p in zip(cache["tail"], base["tail"]):
        xk, xv = kv(p["xattn"])
        blk["xk"].copy_(xk)
        blk["xv"].copy_(xv)
    return cache


def _decode_both(w, params):
    """Token-by-token decode of the batch in both packages from the same
    filled cross cache; returns (port logits, JAX logits, port forward
    logits, JAX forward logits), each (B, S, V)."""
    cfg, batch = w["cfg"], w["batch"]
    tp = convert.params_from_numpy(params, "cpu")
    tb = _torch_batch(batch)
    with torch.no_grad():
        full, _ = model.forward(cfg, tp["base"], tp["adapter"], tb)
        cache = model.init_decode_cache(cfg, B, 16, device="cpu")
        _fill_cross_cache(cfg, tp["base"], cache,
                          model.encode(cfg, tp["base"], tb["frames"]))
        jcache = _jnp(tree_map(lambda t: t.numpy().copy(), cache))
        jp = _jnp(params)
        _, jfull = w["jfwd"](jp, _jnp(batch))
        got, want = [], []
        for t in range(S):
            tok = batch["tokens"][:, t:t + 1]
            pos = np.full((B, 1), t, np.int32)
            lg, cache = model.decode_step(
                cfg, tp["base"], tp["adapter"], cache,
                {"token": torch.from_numpy(tok),
                 "positions": torch.from_numpy(pos)})
            jlg, jcache = w["jdecode"](jp, jcache, {
                "token": jnp.asarray(tok), "positions": jnp.asarray(pos)})
            got.append(lg[:, 0].numpy())
            want.append(np.asarray(jlg[:, 0]))
    return (np.stack(got, 1), np.stack(want, 1), full.numpy(),
            np.asarray(jfull))


def test_decode_with_cross_cache_matches_jax_and_forward(w):
    """Adapters off zero except ``xattn``'s: decode equals the forward
    (tests/test_decode_consistency.py's 2e-3), and the JAX decode step for
    step."""
    got, want, full, jfull = _decode_both(w, _xattn_zero(w["params"]))
    _rel_close(got, want, what="decode vs JAX decode")
    np.testing.assert_allclose(got, full, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(want, jfull, rtol=2e-3, atol=2e-3)


def test_xattn_adapter_caveat_is_the_same_in_both_packages(w):
    """Decode's cross step applies no ``xattn`` adapter and the forward
    does (the JAX package's own behaviour): with them off zero, decode
    parts from the forward, by the same amount in both packages."""
    got, want, full, jfull = _decode_both(w, w["params"])
    gap, jgap = got - full, want - jfull
    assert np.abs(jgap).max() > 1e-2          # the caveat is visible
    _rel_close(gap, jgap, tol=1e-3, what="decode - forward gap")
    _rel_close(got, want, what="decode vs JAX decode")


@pytest.fixture(scope="module")
def train_steps(w):
    """Both packages' train steps at microbatches 2 (frames split along the
    batch), and the port's at 1, from the same params and batch."""
    jcfg, cfg = w["jcfg"], w["cfg"]
    batch = _batch(cfg, seed=6)
    batch = {k: np.concatenate([v, v[::-1]]) for k, v in batch.items()}
    js = jsteps.make_train_step(jcfg, lr=1e-3, microbatches=2)
    jp = _jnp(w["params"])
    out = {"jax": jax.jit(js)(jp, js.optimizer.init(jp["adapter"]),
                              _jnp(batch))}
    for k in (1, 2):
        st = steps.make_train_step(cfg, lr=1e-3, microbatches=k)
        out[k] = st(w["tp"], st.optimizer.init(w["tp"]["adapter"]), batch)
    return out


def test_train_step_microbatches_and_jax(train_steps):
    (p1, _, m1), (p2, o2, m2) = train_steps[1], train_steps[2]
    jp2, jo2, jm = train_steps["jax"]
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(p1["adapter"]), tree_leaves(p2["adapter"]),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
    assert set(m2) == set(jm)
    for k in m2:
        _rel_close(float(m2[k]), float(jm[k]), what=k)
    # AdamW's first moment is 0.1 x the accumulated gradients
    for mu, jmu in zip(tree_leaves(o2["mu"]), jax.tree.leaves(jo2["mu"]),
                       strict=True):
        _grad_close(10 * mu.numpy(), 10 * np.asarray(jmu), what="gradient")
    _updated_close(p2["adapter"], jp2["adapter"], jo2["mu"], lr=1e-3)


def _updated_close(adapter, jadapter, jmu, lr):
    """The adapters after one AdamW step against JAX's: at the JAX step
    test's tolerances where the gradient (10 x AdamW's first moment) is
    above 1e-4 of the leaf's largest entry; below it AdamW's first step,
    lr·g/(|g| + eps), maps round-off of a near-zero gradient to anything
    within ±lr, so there within one step each way."""
    for a, b, m in zip(tree_leaves(adapter), jax.tree.leaves(jadapter),
                       jax.tree.leaves(jmu), strict=True):
        a, b, m = a.numpy(), np.asarray(b), np.abs(np.asarray(m))
        big = m > 1e-4 * m.max()
        np.testing.assert_allclose(a[big], b[big], rtol=2e-4, atol=2e-5)
        assert np.abs(a - b).max() <= 2 * lr


def test_prefill_and_serve_steps_match_jax(w):
    jcfg, cfg, params, tp = w["jcfg"], w["cfg"], w["params"], w["tp"]
    batch = {k: v for k, v in w["batch"].items() if k != "labels"}
    want = jsteps.make_prefill_step(jcfg)(_jnp(params), _jnp(batch))
    got = steps.make_prefill_step(cfg)(tp, batch)
    assert got.shape == (B, cfg.padded_vocab)
    _rel_close(got[:, :cfg.vocab_size], np.asarray(want)[:, :cfg.vocab_size],
               what="prefill")
    cache = model.init_decode_cache(cfg, B, 16, device="cpu")
    with torch.no_grad():
        _fill_cross_cache(cfg, tp["base"], cache, model.encode(
            cfg, tp["base"], torch.from_numpy(batch["frames"])))
    jcache = _jnp(tree_map(lambda t: t.numpy().copy(), cache))
    jserve_step = jax.jit(jsteps.make_serve_step(jcfg))
    serve_step = steps.make_serve_step(cfg)
    for t in range(2):
        x = {"token": batch["tokens"][:, t:t + 1],
             "positions": np.full((B, 1), t, np.int32)}
        jl, jcache = jserve_step(_jnp(params), jcache, _jnp(x))
        lg, cache = serve_step(tp, cache, x)
        assert lg.shape == (B, cfg.padded_vocab)
        _rel_close(lg[:, :cfg.vocab_size],
                   np.asarray(jl)[:, :cfg.vocab_size], what=f"serve {t}")
    # the cross K/V are read, never written
    np.testing.assert_array_equal(cache["groups"]["0"]["xk"].numpy(),
                                  np.asarray(jcache["groups"]["0"]["xk"]))


def test_generate_and_serve_engine_match_jax(w):
    """Zero cross K/V in a fresh cache: the cross term is exactly zero in
    both packages; tokens equal JAX's, and ServeEngine's equal the JAX
    engine's and the port's serve_naive's."""
    jcfg, cfg, params, tp = w["jcfg"], w["cfg"], w["params"], w["tp"]
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(jserve.generate(jcfg, _jnp(params),
                                      jnp.asarray(prompts), 6))
    got = serve.generate(cfg, tp, prompts, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)

    bank = random_bank(cfg, 3, torch.Generator().manual_seed(8))
    jbank = _jax_bank(bank)
    reqs = jserve.make_requests(jbank, 4, prompt_len=6, gen=6,
                                vocab=jcfg.vocab_size, seed=9)
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
    # the bank carries every adapter leaf, the xattn ones too, stacked on
    # a leading client axis
    ours = dict(zip(_paths(bank.tree), tree_leaves(bank.tree)))
    model_ad = dict(zip(_paths(params["adapter"]),
                        tree_leaves(params["adapter"])))
    assert ours.keys() == model_ad.keys()
    assert any("/xattn/" in k for k in ours)
    assert all(tuple(t.shape) == (3,) + model_ad[k].shape
               for k, t in ours.items())


