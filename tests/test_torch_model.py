"""PyTorch port of the model stack (``repro_torch.models`` / ``core``).

The same params — drawn by the JAX package, moved across with
``repro_torch.convert`` — go through the JAX and the port's functions on
the same numpy inputs.  Tolerances: layers and tri-LoRA algebra 2e-5 (f32,
one op chain); ``decode_step`` logits atol/rtol 1e-4 over 6 steps, because
the two frameworks sum in a different order inside every matmul and the
rounding differences grow through the layers and the tied vocab head;
caches 2e-5 (they hold k/v of one projection per layer).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import adapter_bank as jbank_mod
from repro.core import tri_lora as jtri
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.config import get_config as jget_config
from repro_torch import convert
from repro_torch.core import tri_lora
from repro_torch.models import layers, model
from repro_torch.models.config import ModelConfig, get_config, list_configs
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def _jcfg(**kw):
    from repro.models.config import ModelConfig as JConfig
    return JConfig(**{**TINY, **kw})


def _paths(tree, prefix=""):
    """{key path: leaf} over dict/tuple trees (None subtrees dropped)."""
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
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["celora-roberta-base", "celora-llama-7b",
                                  "fed-100m", "rwkv6-1.6b"])
def test_paper_configs_match_jax(name):
    ours, theirs = get_config(name), jget_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    assert ours.stack_plan() == theirs.stack_plan()
    assert (ours.hd, ours.padded_vocab) == (theirs.hd, theirs.padded_vocab)
    assert ours.dtype == {"bfloat16": torch.bfloat16,
                          "float32": torch.float32}[ours.param_dtype]
    assert name in list_configs()


# ---------------------------------------------------------------------------
# layers and tri-LoRA algebra
# ---------------------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32) * 0.1
    bias = rng.standard_normal((16,)).astype(np.float32) * 0.1
    pos = rng.integers(0, 50, (2, 3)).astype(np.int32)
    t = torch.from_numpy
    cases = [
        (layers.rmsnorm(t(x), t(scale)), jlayers.rmsnorm(x, scale)),
        (layers.layernorm(t(x), t(1 + scale), t(bias)),
         jlayers.layernorm(x, 1 + scale, bias)),
        (layers.apply_rope(t(x), t(pos), 1e4),
         jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
    ]
    for kind in ("swiglu", "gelu"):
        jp = jlayers.init_mlp(jax.random.key(1), 16, 32, kind, jnp.float32)
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        cases.append((layers.mlp(t(x), tp, kind), jlayers.mlp(x, jp, kind)))
    for got, want in cases:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_tri_lora_matches_jax():
    rng = np.random.default_rng(1)
    m, d, k, r = 3, 24, 20, 4
    ad = {"A": rng.standard_normal((d, r)), "C": rng.standard_normal((r, r)),
          "B": rng.standard_normal((r, k))}
    ad = {n: v.astype(np.float32) for n, v in ad.items()}
    bank = {n: rng.standard_normal((m,) + v.shape).astype(np.float32)
            for n, v in ad.items()}
    x = rng.standard_normal((4, 2, d)).astype(np.float32)
    w = rng.standard_normal((d, k)).astype(np.float32)
    rows = np.asarray([2, -1, 0, 2], np.int32)
    tad = convert.params_from_numpy(ad, "cpu")
    tbank = convert.params_from_numpy(bank, "cpu")
    t = torch.from_numpy
    pairs = [
        (tri_lora.adapter_delta(tad, 2.0), jtri.adapter_delta(ad, 2.0)),
        (tri_lora.apply_tri_lora(t(x), tad, 2.0),
         jtri.apply_tri_lora(x, ad, 2.0)),
        (tri_lora.apply_tri_lora_grouped(t(x), tbank, 2.0, t(rows)),
         jtri.apply_tri_lora_grouped(x, bank, 2.0, jnp.asarray(rows))),
        (tri_lora.merge(t(w), tad, 2.0), jtri.merge(w, ad, 2.0)),
        (layers.dense(t(x), t(w), adapter=tbank, lora_scaling=2.0,
                      adapter_rows=t(rows)),
         jlayers.dense(x, w, adapter=bank, lora_scaling=2.0,
                       adapter_rows=jnp.asarray(rows))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    assert tri_lora.is_adapter(tad) and not tri_lora.is_adapter({"A": 1})
    g = torch.Generator().manual_seed(0)
    fresh = tri_lora.init_adapter(g, d, k, r)
    assert torch.equal(fresh["C"], torch.eye(r))
    assert not fresh["B"].any() and fresh["A"].shape == (d, r)


# ---------------------------------------------------------------------------
# params: same tree as the JAX package, and conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"lora_mlp": True, "n_layers": 3},
                                {"pos_type": "learned", "mlp_type": "gelu",
                                 "norm_type": "layernorm"}])
def test_init_params_tree_matches_jax(kw):
    jp = jax.tree.map(np.asarray, jmodel.init_params(_jcfg(**kw),
                                                     jax.random.key(0)))
    tp = model.init_params(ModelConfig(**{**TINY, **kw}),
                           torch.Generator().manual_seed(0))
    jpaths, tpaths = _paths(jp), _paths(tp)
    assert set(jpaths) == set(tpaths)
    for path, leaf in jpaths.items():
        assert tuple(tpaths[path].shape) == leaf.shape, path
        assert _np(tpaths[path]).dtype == np.float32, path
    assert isinstance(tp["base"]["tail"], tuple)


def test_convert_bf16_exact_and_keeps_structure():
    a = np.asarray([1.0, -2.5, 3.140625, 1e-3], np.float32).astype(
        ml_dtypes.bfloat16)
    tree = {"x": (a, None), "y": {"z": np.arange(3, dtype=np.int32)}}
    out = convert.params_from_numpy(tree, "cpu")
    assert isinstance(out["x"], tuple) and out["x"][1] is None
    assert out["x"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out["x"][0]), a.astype(np.float32))
    assert out["y"]["z"].dtype == torch.int32


# ---------------------------------------------------------------------------
# decode_step against the JAX model on the same params
# ---------------------------------------------------------------------------

def _setup_decode(seed=0):
    jcfg, tcfg = _jcfg(), ModelConfig(**TINY)
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def test_decode_step_scalar_idx_matches_jax():
    jcfg, tcfg, jp, tp = _setup_decode()
    b, steps, ring = 2, 6, 8
    rng = np.random.default_rng(3)
    toks = rng.integers(0, TINY["vocab_size"], (steps, b, 1)).astype(np.int32)
    jc = jmodel.init_decode_cache(jcfg, b, ring)
    tc = model.init_decode_cache(tcfg, b, ring, device="cpu")
    jstep = jax.jit(lambda c, bt: jmodel.decode_step(
        jcfg, jp["base"], jp["adapter"], c, bt))
    for t in range(steps):
        pos = np.full((b, 1), t, np.int32)
        jl, jc = jstep(jc, {"token": jnp.asarray(toks[t]),
                            "positions": jnp.asarray(pos)})
        with torch.inference_mode():
            tl, tc = model.decode_step(
                tcfg, tp["base"], tp["adapter"], tc,
                {"token": torch.from_numpy(toks[t]),
                 "positions": torch.from_numpy(pos)})
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    jpaths, tpaths = _paths(jax.tree.map(np.asarray, jc)), _paths(tc)
    assert set(jpaths) == set(tpaths)
    for path, leaf in jpaths.items():
        np.testing.assert_allclose(_np(tpaths[path]), leaf, rtol=2e-5,
                                   atol=2e-5, err_msg=path)


def test_decode_step_ragged_bank_matches_jax():
    """Ragged per-row positions + per-row bank adapters.  Row 2 is a masked
    slot (idx -1, row -1): the port's kernels zero it where the JAX path
    keeps x·W and averages V, so logits compare on ACTIVE rows only; the
    masked row's cache stays untouched in both."""
    jcfg, tcfg, jp, tp = _setup_decode()
    jbank = jbank_mod.random_bank(jcfg, 3, jax.random.key(1))
    tbank = convert.bank_from_numpy(jax.tree.map(np.asarray, jbank.tree),
                                    users=jbank.users, device="cpu")
    assert (tbank.n_clients, tbank.rank) == (3, jbank.rank)
    jdec, tdec = jbank.decode_tree(), tbank.decode_tree()
    b, ring = 4, 8
    rows = np.asarray([0, 2, -1, 2], np.int32)
    start = np.asarray([0, 3, -1, 5], np.int32)
    active = rows >= 0
    rng = np.random.default_rng(4)
    jc = jmodel.init_decode_cache(jcfg, b, ring)
    tc = model.init_decode_cache(tcfg, b, ring, device="cpu")

    def with_idx(c, idx, lib):
        g = c["groups"]
        q = g["0"]["k"].shape[0]
        idx_q = lib(np.broadcast_to(idx, (q, b)).copy())
        return {"groups": {"0": {**g["0"], "idx": idx_q}},
                "tail": c["tail"]}

    jstep = jax.jit(lambda c, bt, r: jmodel.decode_step(
        jcfg, jp["base"], jdec, c, bt, adapter_rows=r))
    for t in range(6):
        idx = np.where(active, start + t, -1).astype(np.int32)
        toks = rng.integers(0, TINY["vocab_size"], (b, 1)).astype(np.int32)
        jl, jc = jstep(with_idx(jc, idx, jnp.asarray),
                       {"token": jnp.asarray(toks),
                        "positions": jnp.asarray(idx[:, None])},
                       jnp.asarray(rows))
        with torch.inference_mode():
            tl, tc = model.decode_step(
                tcfg, tp["base"], tdec, with_idx(tc, idx, torch.from_numpy),
                {"token": torch.from_numpy(toks),
                 "positions": torch.from_numpy(idx[:, None])},
                adapter_rows=torch.from_numpy(rows))
        np.testing.assert_allclose(_np(tl)[active], _np(jl)[active],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(_np(tc["groups"]["0"]["idx"]),
                                      np.asarray(jc["groups"]["0"]["idx"]))
    for key in ("k", "v"):
        got, want = _np(tc["groups"]["0"][key]), _np(jc["groups"]["0"][key])
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        assert not got[:, 2].any()      # masked row: never written


def test_bank_views_match_jax():
    jcfg = _jcfg(n_layers=3, lora_mlp=True)
    jbank = jbank_mod.random_bank(jcfg, 4, jax.random.key(2))
    tbank = convert.bank_from_numpy(jax.tree.map(np.asarray, jbank.tree),
                                    users=jbank.users, device="cpu")
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    views = [(tbank.row(1), jbank.row(1)),
             (tbank.decode_tree(), jbank.decode_tree()),
             (tbank.merged_base(tp["base"], 3, 4.0),
              jbank.merged_base(jp["base"], 3, 4.0))]
    for got, want in views:
        gp, wp = _paths(got), _paths(jax.tree.map(np.asarray, want))
        assert set(gp) == set(wp)
        for path, leaf in wp.items():
            np.testing.assert_allclose(_np(gp[path]), _np(leaf), rtol=2e-5,
                                       atol=2e-5, err_msg=path)
    assert torch.equal(tbank.rows(["client-2", None]),
                       torch.tensor([2, -1], dtype=torch.int32))
    with pytest.raises(KeyError, match="no adapter bank row"):
        tbank.lookup("nobody")
    with pytest.raises(IndexError):
        tbank.row(4)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tbank.tree))
