"""The port's RWKV-6 family (``repro_torch.models.rwkv``, the rwkv6 block
kind and the wkv6 op) against the JAX package, on the CPU.

Both packages get the same numpy inputs and, for the model, the JAX
package's parameters moved across by ``convert.params_from_numpy``.  Every
parameter that JAX initialises to zero or a constant (the ddlerp bases and
low-rank B factor, the decay base and its low-rank B factor, the bonus u,
the group-norm scale, the channel-mix lerps, the adapters' B) is perturbed
first, so the data-dependent decay and the bonus term are exercised.

On the CPU ``ops.wkv6`` runs its plain version (the log-space chunked
recurrence at chunk 32, what the JAX kernel computes in interpret mode);
the CUDA kernel is held to ``wkv6_ref`` on the card in
tests/test_torch_cuda_kernels.py.  The JAX outputs that need the Pallas
kernel in interpret mode are computed once, in a fresh interpreter
(tests/conftest.py keeps interpret-mode Pallas out of the long in-process
session).

Tolerances, all f32: the WKV recurrences 1e-4 (tests/test_kernels.py);
layers, logits, decode states and adapter gradients 1e-4 (the frameworks
sum in another order inside every matmul, over up to 300 recurrent steps),
with the absolute part scaled by the largest entry for the gradients and
the carried decode state.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import wkv6_ref as jwkv6_ref
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro.models.config import get_config as jget_config
from repro_torch import convert
from repro_torch.core.adapter_bank import random_bank
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.launch import serve
from repro_torch.models import layers, model, rwkv
from repro_torch.models.config import get_config
from repro_torch.tree import tree_map
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-1.6b"
TOL = dict(rtol=1e-4, atol=1e-4)
#: (T, H, hd) of the JAX package's wkv6 kernel tests (B = 2)
WKV_SHAPES = [(64, 2, 16), (80, 2, 16), (33, 1, 8), (128, 4, 32)]
#: (T, use_kernel) of the time-mix cases: the scan, chunked and kernel
#: branches of ``time_mix``'s dispatch
TIME_MIX_CASES = [(40, False), (300, False), (40, True)]
FORWARD_CASES = [(40, False), (40, True), (300, False), (300, True)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


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


# ---------------------------------------------------------------------------
# shared inputs (both processes build them from the same seeds)
# ---------------------------------------------------------------------------

def _wkv_inputs(b, t, h, hd, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, hd)).astype(np.float32)
               for _ in range(3))
    w = (1 / (1 + np.exp(-2 * rng.standard_normal((b, t, h, hd))))).astype(
        np.float32)
    u = (0.5 * rng.standard_normal((h, hd))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((b, h, hd, hd))).astype(np.float32)
    return r, k, v, w, u, s0


def _extreme_inputs():
    """Near-total forgetting (tests/test_kernels.py): w = 1e-6."""
    b, t, h, hd = 1, 64, 1, 8
    return (np.full((b, t, h, hd), 0.5, np.float32),
            np.full((b, t, h, hd), 0.5, np.float32),
            np.ones((b, t, h, hd), np.float32),
            np.full((b, t, h, hd), 1e-6, np.float32),
            np.zeros((h, hd), np.float32),
            np.zeros((b, h, hd, hd), np.float32))


def _perturbed(tree, seed):
    """Every zero- or constant-initialised leaf of a numpy param / adapter
    tree moved off its init: lerps and the bonus ~N(0, 0.5), the low-rank
    B factors ~N(0, 0.1), the decay base uniform in [-4, 0.5] (decays
    from ~0.98 down to ~0.2 a step), the norm scales 1 + N(0, 0.1), the
    adapters' B ~N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        name = path.rsplit("/", 1)[-1]
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name in ("mu_x", "mu", "u", "mu_k", "mu_r"):
            return a + 0.5 * noise
        if name in ("mix_b", "w_b"):
            return a + 0.1 * noise
        if name == "w0":
            return rng.uniform(-4.0, 0.5, a.shape).astype(np.float32)
        if name in ("ln_x", "scale"):
            return a + 0.1 * noise
        if name == "B":
            return a + 0.05 * noise
        return a
    flat = _paths(tree)
    moved = {p: move(p, np.asarray(a, np.float32)) for p, a in flat.items()}

    def rebuild(t, prefix=""):
        if isinstance(t, dict):
            return {k: rebuild(v, f"{prefix}/{k}") for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(rebuild(v, f"{prefix}/{i}") for i, v in enumerate(t))
        return None if t is None else moved[prefix]
    return rebuild(tree)


@functools.lru_cache(maxsize=1)
def _jax_init():
    """The reduced rwkv6-1.6b params (f32) as the JAX package draws them,
    as a numpy tree."""
    cfg = jget_config(ARCH).reduced()
    jp = jax.jit(jmodel.init_params, static_argnums=0)(cfg,
                                                       jax.random.key(0))
    return jax.tree.map(np.asarray, jp)


def _jax_params():
    """:func:`_jax_init`'s params, perturbed."""
    return _perturbed(_jax_init(), 1)


def _time_mix_inputs(cfg, t, seed):
    rng = np.random.default_rng(seed)
    b, d, h, hd = 2, cfg.d_model, cfg.n_heads, cfg.hd
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    state = {"shift": rng.standard_normal((b, d)).astype(np.float32),
             "wkv": (0.1 * rng.standard_normal((b, h, hd, hd))).astype(
                 np.float32)}
    return x, state


def _tokens(t, seed):
    return np.random.default_rng(seed).integers(
        0, get_config(ARCH).reduced().vocab_size, (2, t)).astype(np.int32)


def _jax_kernel_outputs(path):
    """Every JAX output that runs the Pallas wkv6 kernel (interpret mode),
    saved to ``path``.  Runs in a fresh interpreter."""
    from repro.kernels.rwkv6 import wkv6 as jwkv6

    out = {}
    for i, (t, h, hd) in enumerate(WKV_SHAPES):
        y, s = jwkv6(*_wkv_inputs(2, t, h, hd, i), interpret=True)
        out[f"wkv{i}_y"], out[f"wkv{i}_s"] = y, s
    y, s = jwkv6(*_extreme_inputs(), chunk=16, interpret=True)
    out["extreme_y"], out["extreme_s"] = y, s
    cfg = jget_config(ARCH).reduced()
    jp = _jax_params()
    p, ad = jp["base"]["groups"]["0"], jp["adapter"]["groups"]["0"]
    tm = jax.tree.map(lambda a: a[0], p["tm"])
    tad = jax.tree.map(lambda a: a[0], ad["tm"])
    for t, kern in TIME_MIX_CASES:
        if kern:
            x, st = _time_mix_inputs(cfg, t, t)
            y, new = jax.jit(lambda *a: jrwkv.time_mix(
                cfg, *a, use_kernel=True))(tm, x, st, tad)
            out[f"tm{t}_y"] = y
            out[f"tm{t}_shift"], out[f"tm{t}_wkv"] = new["shift"], new["wkv"]
    for t, kern in FORWARD_CASES:
        if kern:
            logits, _ = jax.jit(lambda b: jmodel.forward(
                cfg, jp["base"], jp["adapter"], b, use_rwkv_kernel=True))(
                    {"tokens": jnp.asarray(_tokens(t, t))})
            out[f"fwd{t}"] = logits
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in out.items()})


@pytest.fixture(scope="module")
def jax_kernel():
    """The JAX Pallas-kernel outputs, from a fresh interpreter."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "jax_kernel.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT / "src"), str(ROOT / "tests"),
                        env.get("PYTHONPATH")) if p)
        code = ("import test_torch_rwkv as m; "
                f"m._jax_kernel_outputs({path!r})")
        run = subprocess.run([sys.executable, "-c", code], env=env,
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        assert run.returncode == 0, run.stderr[-3000:]
        with np.load(path) as z:
            return dict(z)


@pytest.fixture(scope="module")
def rwkv_params():
    """(port cfg, JAX cfg, JAX numpy params, port params)."""
    jp = _jax_params()
    return (get_config(ARCH).reduced(), jget_config(ARCH).reduced(),
            jax.tree.map(jnp.asarray, jp), convert.params_from_numpy(jp,
                                                                     "cpu"))


# ---------------------------------------------------------------------------
# the WKV recurrences: plain versions of the kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(WKV_SHAPES)))
def test_wkv_plain_versions_match_jax_kernel_and_ref(case, jax_kernel):
    t, h, hd = WKV_SHAPES[case]
    ins = _wkv_inputs(2, t, h, hd, case)
    tins = [torch.from_numpy(a) for a in ins]
    want_y, want_s = (np.asarray(a) for a in jwkv6_ref(*ins))
    wkv_ops.reset_launches()
    got = {"scan": rwkv.wkv_scan(*tins), "chunked": rwkv.wkv_chunked(*tins),
           "ref": wkv_ref.wkv6_ref(*tins), "op": wkv_ops.wkv6(*tins)}
    assert wkv_ops.LAUNCHES == {"wkv6": 0}        # the CPU takes no kernel
    for name, (y, s) in got.items():
        assert y.dtype == s.dtype == torch.float32, name
        for want in ((want_y, want_s),
                     (jax_kernel[f"wkv{case}_y"], jax_kernel[f"wkv{case}_s"])):
            np.testing.assert_allclose(_np(y), want[0], **TOL, err_msg=name)
            np.testing.assert_allclose(_np(s), want[1], **TOL, err_msg=name)


def test_wkv_extreme_decay_stays_finite(jax_kernel):
    tins = [torch.from_numpy(a) for a in _extreme_inputs()]
    want_y, want_s = (np.asarray(a) for a in jwkv6_ref(*_extreme_inputs()))
    for fn in (rwkv.wkv_scan, rwkv.wkv_chunked, wkv_ops.wkv6):
        y, s = fn(*tins)
        assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
        for wy, ws in ((want_y, want_s),
                       (jax_kernel["extreme_y"], jax_kernel["extreme_s"])):
            np.testing.assert_allclose(_np(y), wy, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(_np(s), ws, rtol=1e-4, atol=1e-5)


def test_wkv6_op_refuses_gradients_and_bad_shapes():
    """The JAX kernel has no VJP: the op raises rather than compute a
    differentiable result another way, through the model too."""
    tins = [torch.from_numpy(a) for a in _wkv_inputs(1, 5, 2, 8, 0)]
    r = tins[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no VJP"):
        wkv_ops.wkv6(r, *tins[1:])
    with torch.no_grad():
        y, _ = wkv_ops.wkv6(r, *tins[1:])        # nothing to differentiate
    assert not y.requires_grad
    with pytest.raises(ValueError, match="shape"):
        wkv_ops.wkv6(*tins[:4], tins[4][:1], tins[5])
    cfg = get_config(ARCH).reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    ad = tree_map(lambda a: a.requires_grad_(True), params["adapter"])
    batch = {"tokens": torch.zeros((1, 6), dtype=torch.int32),
             "labels": torch.zeros((1, 6), dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="no VJP"):
        model.loss_fn(cfg, ad, params["base"], batch, use_rwkv_kernel=True)
    loss, _ = model.loss_fn(cfg, ad, params["base"], batch)
    assert loss.requires_grad


def test_wkv6_kernel_tiling_covers_every_head_dim():
    """wkv6.cu is compiled for the head dims ``ops`` admits on the card,
    and one block of a (b, h) covers each of them: its key slices hold
    every key 1..MAX_HD and its column groups every value column, in whole
    warps; the entry points refuse a wider head."""
    import re

    from repro_torch.kernels import build
    text = build.sources()["wkv6"].read_text()
    const = {name: int(val) for name, val in re.findall(
        r"constexpr int (k[A-Za-z]+) = (\d+);", text)}
    max_hd, cpt, slices = const["kMaxHd"], const["kCpt"], const["kSlices"]
    assert max_hd == wkv_ops.MAX_HD
    assert max_hd % slices == 0 and max_hd % cpt == 0
    assert slices * (max_hd // cpt) % 32 == 0
    for hd in range(1, wkv_ops.MAX_HD + 1):
        assert -(-hd // (max_hd // slices)) <= slices
        assert -(-hd // cpt) <= max_hd // cpt
    assert "hd > kMaxHd" in text


def _route_inputs(hd, dtype=torch.bfloat16, w_dtype=torch.float32):
    r, k, v = (torch.zeros((2, 5, 3, hd), dtype=dtype) for _ in range(3))
    return r, k, v, torch.zeros((2, 5, 3, hd), dtype=w_dtype)


def _wide_views(hd):
    wide = torch.zeros((2, 5, 3 * 3 * hd), dtype=torch.bfloat16)
    return tuple(wide[..., i * 3 * hd:(i + 1) * 3 * hd].view(2, 5, 3, hd)
                 for i in range(3))


def _shifted(t):
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("make,want", [
    (lambda: _route_inputs(64), "vec"),
    (lambda: _route_inputs(48), "vec"),
    (lambda: _route_inputs(8, torch.float32), "vec"),
    (lambda: _route_inputs(64, torch.float32, torch.bfloat16), "vec"),
    (lambda: _route_inputs(17), "scalar"),             # 34-byte rows
    (lambda: _route_inputs(4), "scalar"),              # 8-byte rows
    (lambda: (*_wide_views(64), _route_inputs(64)[3]), "vec"),
    (lambda: (*_route_inputs(64)[:3], _shifted(_route_inputs(64)[3])),
     "scalar"),                                        # w 4 bytes off
    (lambda: (_shifted(_route_inputs(64)[0]), *_route_inputs(64)[1:]),
     "scalar"),                                        # r 2 bytes off
], ids=["bf16-64", "bf16-48", "f32-8", "f32-bf16w", "bf16-17", "bf16-4",
        "wide-views", "w-shifted", "r-shifted"])
def test_wkv6_route_follows_strides_and_alignment(make, want):
    """The kernel's route is chosen from r, k, v and w alone (base
    addresses, strides and the row of hd elements) before any launch: one
    operand the 16-byte copies cannot read sends the call to the scalar
    route."""
    assert wkv_ops.route(*make()) == want


def test_cpu_wkv6_counts_no_launch_or_route():
    """On CPU tensors wkv6 runs its plain version: no kernel launch and no
    route is counted."""
    wkv_ops.reset_launches()
    wkv_ops.wkv6(*(torch.from_numpy(a) for a in _wkv_inputs(1, 5, 2, 8, 0)))
    assert wkv_ops.LAUNCHES == {"wkv6": 0}
    assert wkv_ops.ROUTES == {"wkv6_vec": 0, "wkv6_scalar": 0}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_group_rmsnorm_matches_jax():
    rng = np.random.default_rng(7)
    x = (3 * rng.standard_normal((2, 5, 256)) + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    got = layers.group_rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 4)
    np.testing.assert_allclose(_np(got), np.asarray(
        jlayers.group_rmsnorm(x, scale, 4)), rtol=2e-5, atol=2e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert layers.group_rmsnorm(xb, torch.from_numpy(scale), 4).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("t,kern", TIME_MIX_CASES)
def test_time_mix_matches_jax(t, kern, rwkv_params, jax_kernel):
    """With a state in and out, through the scan (T ≤ 256), chunked
    (T > 256) and kernel branches of the dispatch."""
    cfg, jcfg, jp, tp = rwkv_params
    x, st = _time_mix_inputs(cfg, t, t)
    jtm = jax.tree.map(lambda a: a[0], jp["base"]["groups"]["0"]["tm"])
    jad = jax.tree.map(lambda a: a[0], jp["adapter"]["groups"]["0"]["tm"])
    ttm = tree_map(lambda a: a[0], tp["base"]["groups"]["0"]["tm"])
    tad = tree_map(lambda a: a[0], tp["adapter"]["groups"]["0"]["tm"])
    with torch.inference_mode():
        y, new = rwkv.time_mix(cfg, ttm, torch.from_numpy(x),
                               tree_map(torch.from_numpy, st), tad,
                               use_kernel=kern)
    if kern:
        want = (jax_kernel[f"tm{t}_y"], jax_kernel[f"tm{t}_shift"],
                jax_kernel[f"tm{t}_wkv"])
    else:
        wy, wnew = jax.jit(lambda p, a, x_, s_: jrwkv.time_mix(
            jcfg, p, x_, s_, a))(jtm, jad, x, st)
        want = (wy, wnew["shift"], wnew["wkv"])
    for got, w in zip((y, new["shift"], new["wkv"]), want):
        np.testing.assert_allclose(_np(got), np.asarray(w), **TOL)


def test_channel_mix_matches_jax(rwkv_params):
    cfg, jcfg, jp, tp = rwkv_params
    x, st = _time_mix_inputs(cfg, 17, 3)
    jcm = jax.tree.map(lambda a: a[0], jp["base"]["groups"]["0"]["cm"])
    tcm = tree_map(lambda a: a[0], tp["base"]["groups"]["0"]["cm"])
    shift = {"shift": st["shift"]}
    for s in (shift, None):
        wy, wnew = jrwkv.channel_mix(jcfg, jcm, x, s)
        y, new = rwkv.channel_mix(cfg, tcm, torch.from_numpy(x),
                                  None if s is None else
                                  tree_map(torch.from_numpy, s))
        np.testing.assert_allclose(_np(y), np.asarray(wy), **TOL)
        np.testing.assert_array_equal(_np(new["shift"]),
                                      np.asarray(wnew["shift"]))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_params_and_decode_cache_trees_match_jax():
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    jp = _jax_init()
    tp = model.init_params(cfg, torch.Generator().manual_seed(0))
    jc = jax.tree.map(np.asarray, jmodel.init_decode_cache(jcfg, 3, 16))
    tc = model.init_decode_cache(cfg, 3, 16, device="cpu")
    for jt, tt in ((jp, tp), (jc, tc)):
        jpaths, tpaths = _paths(jt), _paths(tt)
        assert set(jpaths) == set(tpaths)
        for path, leaf in jpaths.items():
            assert tuple(tpaths[path].shape) == leaf.shape, path
            assert _np(tpaths[path]).dtype == np.float32, path
    assert set(tp["adapter"]["groups"]["0"]) == {"tm"}
    assert set(tp["adapter"]["groups"]["0"]["tm"]) == {"wr", "wk", "wv", "wo"}
    for name, value in (("w0", -6.0), ("ln_x", 1.0), ("u", 0.0)):
        assert bool((tp["base"]["groups"]["0"]["tm"][name] == value).all())
    assert not any(bool(t.any()) for t in _paths(tc).values())
    full = get_config(ARCH)                      # bf16 shifts, f32 state
    st = rwkv.init_state(full, 2, device="cpu")
    assert st["tm"]["shift"].dtype == torch.bfloat16
    assert st["tm"]["wkv"].dtype == torch.float32
    assert tuple(st["tm"]["wkv"].shape) == (2, 32, 64, 64)


@pytest.mark.parametrize("t,kern", FORWARD_CASES)
def test_forward_matches_jax(t, kern, rwkv_params, jax_kernel):
    """The same keyword on both sides: the kernel branch (JAX's Pallas
    kernel in interpret mode vs the port's plain chunk-32 recurrence) and
    the scan / chunked branch."""
    cfg, jcfg, jp, tp = rwkv_params
    toks = _tokens(t, t)
    with torch.inference_mode():
        got, aux = model.forward(cfg, tp["base"], tp["adapter"],
                                 {"tokens": torch.from_numpy(toks)},
                                 use_rwkv_kernel=kern)
    if kern:
        want = jax_kernel[f"fwd{t}"]
    else:
        want = np.asarray(jax.jit(lambda b: jmodel.forward(
            jcfg, jp["base"], jp["adapter"], b)[0])(
                {"tokens": jnp.asarray(toks)}))
    assert got.shape == (2, t, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_loss_and_adapter_grads_match_jax(rwkv_params):
    cfg, jcfg, jp, tp = rwkv_params
    toks = _tokens(41, 5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda a, b: jmodel.loss_fn(jcfg, a, jp["base"], b),
        has_aux=True))(jp["adapter"], jax.tree.map(jnp.asarray, batch))
    ad = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                  tp["adapter"])
    loss, aux = model.loss_fn(cfg, ad, tp["base"],
                              tree_map(torch.from_numpy, batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["acc"]), float(jaux["acc"]))
    wpaths, gpaths = _paths(jax.tree.map(np.asarray, jgrads)), _paths(ad)
    assert set(wpaths) == set(gpaths)
    for path, want in wpaths.items():
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(_np(gpaths[path].grad) / scale,
                                   want / scale, atol=1e-4, err_msg=path)


def test_decode_steps_match_jax(rwkv_params):
    """12 one-token steps: logits, and the carried state (restacked on the
    group axis) against JAX's.  The WKV state grows to entries of ~50
    where others stay near 0, so each state leaf is held to 1e-4 with the
    absolute part scaled by its largest entry."""
    cfg, jcfg, jp, tp = rwkv_params
    b, steps = 2, 12
    toks = _tokens(steps, 9)
    jc = jmodel.init_decode_cache(jcfg, b, steps)
    tc = model.init_decode_cache(cfg, b, steps, device="cpu")
    jstep = jax.jit(lambda c, bt: jmodel.decode_step(
        jcfg, jp["base"], jp["adapter"], c, bt))
    for t in range(steps):
        pos = np.full((b, 1), t, np.int32)
        jl, jc = jstep(jc, {"token": jnp.asarray(toks[:, t:t + 1]),
                            "positions": jnp.asarray(pos)})
        with torch.inference_mode():
            tl, tc = model.decode_step(
                cfg, tp["base"], tp["adapter"], tc,
                {"token": torch.from_numpy(toks[:, t:t + 1]),
                 "positions": torch.from_numpy(pos)})
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    jpaths, tpaths = _paths(jax.tree.map(np.asarray, jc)), _paths(tc)
    assert set(jpaths) == set(tpaths)
    for path, leaf in jpaths.items():
        scale = max(1.0, float(np.abs(leaf).max()))
        np.testing.assert_allclose(_np(tpaths[path]), leaf, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=path)


def test_generate_matches_jax(rwkv_params):
    cfg, jcfg, jp, tp = rwkv_params
    prompts = _tokens(5, 11)
    want = np.asarray(jserve.generate(jcfg, jp, jnp.asarray(prompts), 7))
    got = serve.generate(cfg, tp, prompts, 7, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_adapter_rows_and_serve_engine_on_rwkv_raise(rwkv_params):
    """Grouped adapter banks need attention blocks, as in the JAX
    package."""
    cfg, _, _, tp = rwkv_params
    cache = model.init_decode_cache(cfg, 2, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="attention blocks"):
        model.decode_step(cfg, tp["base"], tp["adapter"], cache,
                          {"token": torch.zeros((2, 1), dtype=torch.int32),
                           "positions": torch.zeros((2, 1),
                                                    dtype=torch.int32)},
                          adapter_rows=torch.zeros(2, dtype=torch.int32))
    bank = random_bank(cfg, 2, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="attention stacks only"):
        serve.ServeEngine(cfg, tp["base"], bank, slots=2, device="cpu")


def test_bf16_forward_with_f32_adapters_matches_jax():
    """The model's own types: bf16 params and activations, f32 adapters.
    The rank-r path computes in the promoted type (f32), as ``jnp`` does,
    on the CPU's plain path.  2 layers, 12 tokens: bf16 tolerance 2e-2,
    the absolute part scaled by the largest logit."""
    cfg = get_config(ARCH).reduced(param_dtype="bfloat16")
    jcfg = jget_config(ARCH).reduced(param_dtype="bfloat16")
    jp = _perturbed(_jax_init(), 2)           # f32 numpy, perturbed
    jp = {"base": jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp["base"]),
          "adapter": jp["adapter"]}
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["base"]["embed"].dtype == torch.bfloat16
    assert tp["adapter"]["groups"]["0"]["tm"]["wr"]["A"].dtype == torch.float32
    toks = _tokens(12, 13)
    with torch.inference_mode():
        got, _ = model.forward(cfg, tp["base"], tp["adapter"],
                               {"tokens": torch.from_numpy(toks)})
    want = np.asarray(jax.jit(lambda b: jmodel.forward(
        jcfg, jp["base"], jp["adapter"], b)[0])({"tokens": jnp.asarray(toks)}))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_np(got), want, rtol=2e-2, atol=2e-2 * scale)
