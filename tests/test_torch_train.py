"""The port's training-path pieces against the JAX package, on the CPU.

The same numpy inputs (and, where the JAX package draws from
``jax.random``, the JAX package's own draws) go through both packages:

* model: ``forward_hidden``, ``loss_fn`` and ``FedTask.loss`` with adapter
  and head gradients, the port with ``attn_impl`` "ref" and "flash" (its
  plain version on the CPU), the JAX package with "ref".  Tolerance 1e-4
  (atol and rtol): two layers of f32 matmuls summed in another order,
  then a mean over the sequence and a cross entropy, as in
  tests/test_torch_model.py's decode logits;
* numpy modules (data, partition, loader, sampling plans): bit for bit;
* AdamW/SGD over several steps: 1e-6 (the same f32 update, scalars
  rounded the same way);
* GMM/OT/CKA/aggregation: 1e-4 for EM and Sinkhorn (15 and 200 f32
  iterations), 2e-5 for the closed forms; byte ledgers exactly.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import baselines as jbase
from repro.core import comm as jcomm
from repro.core import sampling as jsampling
from repro.core import tri_lora as jtri
from repro.core.fed_model import FedTask as JFedTask
from repro.core.similarity import cka as jcka
from repro.core.similarity import gmm as jgmm
from repro.core.similarity import ot as jot
from repro.data import partition as jpartition
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.core import aggregation, baselines, comm, sampling, tri_lora
from repro_torch.core.similarity import cka, gmm, ot
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401

# the packages export the function ``adamw`` under the module's name
jadamw = importlib.import_module("repro.optim.adamw")
adamw = importlib.import_module("repro_torch.optim.adamw")

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
            rope_theta=1e4, layer_pattern=("attn",), param_dtype="float32",
            lora_rank=4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


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


def _assert_trees_close(got, want, **tol):
    g, w = _paths(got), _paths(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(_np(g[k]), _np(w[k]), err_msg=k, **tol)


# ---------------------------------------------------------------------------
# model: forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_params():
    """JAX params with random (nonzero) B and C, as numpy and as the
    port's tensors."""
    jcfg = JConfig(**TINY)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jmodel.init_params(jcfg, k))(jax.random.key(0)))
    rng = np.random.default_rng(0)
    params["adapter"] = jax.tree.map(
        lambda a: {"A": a["A"], "B": (rng.standard_normal(a["B"].shape)
                                      * 0.1).astype(np.float32),
                   "C": a["C"] + (rng.standard_normal(a["C"].shape)
                                  * 0.1).astype(np.float32)},
        params["adapter"], is_leaf=jtri.is_adapter)
    toks = rng.integers(0, 256, (2, 20)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1                                 # ignored positions
    return jcfg, params, toks, labels


@pytest.fixture(scope="module")
def jax_model_refs(tiny_params):
    """JAX hidden states, LM loss/acc and adapter grads, and the FedTask
    loss/acc, grads and features — one jitted program, shared by both port
    backends."""
    jcfg, params, toks, labels = tiny_params
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jtask = JFedTask(jcfg, jax.tree.map(jnp.asarray, params["base"]), 3)
    cls = jnp.asarray([1, 2], jnp.int32)

    def refs(adapter, head):
        hidden, _, _ = jmodel.forward_hidden(jcfg, params["base"], adapter,
                                             jbatch, attn_impl="ref")
        lm = jax.value_and_grad(
            lambda a: jmodel.loss_fn(jcfg, a, params["base"], jbatch,
                                     attn_impl="ref"), has_aux=True)(adapter)
        task = jax.value_and_grad(
            lambda t: jtask.loss(t, jbatch["tokens"], cls),
            has_aux=True)({"adapter": adapter, "head": head})
        return hidden, lm, task, jtask.features(jbatch["tokens"])

    head = (np.random.default_rng(1).standard_normal((64, 3)) * 0.1
            ).astype(np.float32)
    out = jax.jit(refs)(params["adapter"], head)
    return head, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_forward_and_loss_fn_match_jax(tiny_params, jax_model_refs, impl):
    jcfg, params, toks, labels = tiny_params
    _, (jhidden, ((jloss, jstats), jgrads), _, _) = jax_model_refs
    cfg = ModelConfig(**TINY)
    base = convert.params_from_numpy(params["base"], "cpu")
    adapter = tree_map(lambda t: t.requires_grad_(True),
                       convert.params_from_numpy(params["adapter"], "cpu"))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    hidden, aux, _ = model.forward_hidden(cfg, base, adapter, batch,
                                          attn_impl=impl)
    np.testing.assert_allclose(_np(hidden), jhidden, **MODEL_TOL)
    logits, _ = model.forward(cfg, base, adapter, batch, attn_impl=impl)
    assert logits.shape == (2, 20, 256) and float(aux) == 0.0

    loss, stats = model.loss_fn(cfg, adapter, base, batch, attn_impl=impl)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **MODEL_TOL)
    np.testing.assert_allclose(stats["acc"].item(), float(jstats["acc"]),
                               atol=1e-6)
    _assert_trees_close(tree_map(lambda t: t.grad, adapter), jgrads,
                        **MODEL_TOL)


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_fed_task_loss_and_features_match_jax(tiny_params, jax_model_refs,
                                              impl):
    _, params, toks, _ = tiny_params
    head, (_, _, ((jloss, jacc), jgrads), jfeats) = jax_model_refs
    labels = np.asarray([1, 2], np.int32)
    task = convert.fed_task_from_numpy(
        ModelConfig(**TINY, attn_impl=impl), params["base"], 3, "cpu")
    trainable = convert.params_from_numpy(
        {"adapter": params["adapter"], "head": head}, "cpu")
    trainable = tree_map(lambda t: t.requires_grad_(True), trainable)

    loss, acc = task.loss(trainable, torch.from_numpy(toks),
                          torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **MODEL_TOL)
    assert acc.item() == float(jacc)
    _assert_trees_close(tree_map(lambda t: t.grad, trainable), jgrads,
                        **MODEL_TOL)
    np.testing.assert_allclose(_np(task.features(torch.from_numpy(toks))),
                               jfeats, **MODEL_TOL)


def test_init_client_and_pretrain_shapes():
    """Port-drawn clients have the JAX package's tree paths and shapes
    (C = I, B = 0); the warm-up changes the base and nothing else."""
    cfg = ModelConfig(**TINY)
    jcfg = JConfig(**TINY)
    from repro_torch.core.fed_model import FedTask
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 256, (4, 8)).astype(np.int32),
                "labels": rng.integers(0, 3, 4).astype(np.int32)}
               for _ in range(2)]
    task = FedTask.create(g, cfg, 3, pretrain_batches=batches)
    client = task.init_client(g)
    jclient = jax.eval_shape(JFedTask(jcfg, None, 3).init_client,
                             jax.random.key(0))
    got, want = _paths(client), _paths(jclient)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for a in tri_lora.adapters_of(client["adapter"]):
        assert torch.equal(a["C"][0], torch.eye(4)) and not a["B"].any()
    fresh = model.init_params(cfg, torch.Generator().manual_seed(0))["base"]
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_leaves(task.base), tree_leaves(fresh))]
    assert any(moved)


# ---------------------------------------------------------------------------
# numpy modules: bit for bit
# ---------------------------------------------------------------------------

def test_data_streams_match_jax_bit_for_bit():
    a = synthetic.make_classification_data(3, 50, 12, 64, 4, class_sep=1.5)
    b = jsynthetic.make_classification_data(3, 50, 12, 64, 4, class_sep=1.5)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.labels, b.labels)
    fa = synthetic.make_federated_classification(1, 5, 30, 10, 8, 64, 3,
                                                 drift=0.7)
    fb = jsynthetic.make_federated_classification(1, 5, 30, 10, 8, 64, 3,
                                                  drift=0.7)
    for ca, cb in zip(fa[0] + fa[1], fb[0] + fb[1]):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(ca[k], cb[k])
    np.testing.assert_array_equal(fa[2], fb[2])
    np.testing.assert_array_equal(synthetic.make_lm_data(2, 500, 64),
                                  jsynthetic.make_lm_data(2, 500, 64))
    la = next(synthetic.lm_batches(np.arange(100), 3, 8, seed=4))
    lb = next(jsynthetic.lm_batches(np.arange(100), 3, 8, seed=4))
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k])
    shards_a = partition.dirichlet_partition(0, a.labels, 4, 0.5)
    shards_b = jpartition.dirichlet_partition(0, a.labels, 4, 0.5)
    for sa, sb in zip(shards_a, shards_b):
        np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(
        partition.label_histogram(a.labels, shards_a),
        jpartition.label_histogram(a.labels, shards_b))


@pytest.mark.parametrize("n,batch,drop_last", [(23, 5, False), (20, 5, False),
                                               (23, 5, True), (3, 8, False)])
def test_loader_and_skip_match_jax(n, batch, drop_last):
    arrays = {"x": np.arange(n * 2).reshape(n, 2), "y": np.arange(n)}
    ours = pipeline.Loader(arrays, batch, seed=7, drop_last=drop_last)
    theirs = jpipeline.Loader(arrays, batch, seed=7, drop_last=drop_last)
    for steps in (3, 7, 2):
        for a, b in zip(ours.batches(steps), theirs.batches(steps)):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        ours.skip(steps)
        theirs.skip(steps)
    assert len(ours) == len(theirs)
    np.testing.assert_array_equal(next(ours.batches(1))["x"],
                                  next(theirs.batches(1))["x"])


@pytest.mark.parametrize("sampler", sampling.SAMPLERS)
def test_participation_plans_match_jax(sampler):
    counts = [5, 40, 12, 7, 30, 2, 18, 9, 11, 3]
    for rnd in range(4):
        for part, strag in ((0.4, 0.0), (0.7, 0.3), (1.0, 0.5)):
            a = sampling.build_plan(sampler, 10, part, strag, rnd, 5, counts)
            b = jsampling.build_plan(sampler, 10, part, strag, rnd, 5, counts)
            for f in ("sampled", "dropped", "participants"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(a.mask(10), b.mask(10))
    full = sampling.full_plan(6, 2)
    np.testing.assert_array_equal(full.participants,
                                  jsampling.full_plan(6, 2).participants)
    assert sampling.n_sampled(10, 0.04) == jsampling.n_sampled(10, 0.04)
    with pytest.raises(ValueError):
        sampling.n_sampled(10, 0.0)


# ---------------------------------------------------------------------------
# server pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(lr=1e-2),
                                dict(lr=3e-3, weight_decay=0.1,
                                     grad_clip=0.5)])
def test_adamw_matches_jax_over_steps(kw):
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": (rng.standard_normal((5,)).astype(np.float32),)}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params) for _ in range(5)]
    jopt, opt = jadamw.adamw(**kw), adamw.adamw(**kw)
    jp, js = jax.tree.map(jnp.asarray, params), None
    tp = convert.params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), opt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jadamw.apply_updates(jp, ju)
        tu, ts = opt.update(convert.params_from_numpy(g, "cpu"), ts, tp)
        tp = adamw.apply_updates(tp, tu)
    _assert_trees_close(tp, jax.tree.map(np.asarray, jp), rtol=1e-6,
                        atol=1e-6)
    np.testing.assert_allclose(float(adamw.global_norm(tp)),
                               float(jadamw.global_norm(jp)), rtol=1e-6)
    jsgd, tsgd = jadamw.sgd(lr=0.1, momentum=0.9), adamw.sgd(lr=0.1,
                                                             momentum=0.9)
    ju, _ = jsgd.update(jax.tree.map(jnp.asarray, grads[0]),
                        jsgd.init(jp), jp)
    tu, _ = tsgd.update(convert.params_from_numpy(grads[0], "cpu"),
                        tsgd.init(tp), tp)
    _assert_trees_close(tu, jax.tree.map(np.asarray, ju), rtol=1e-6,
                        atol=1e-6)


def test_gmm_fit_matches_jax_with_its_init_indices():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal((30, 6)),
                        rng.standard_normal((20, 6)) + 3]).astype(np.float32)
    key = jax.random.key(11)
    want = jax.jit(lambda k, x_: jgmm.fit_gmm(k, x_, 2, 15))(
        key, jnp.asarray(x))
    idx = np.asarray(jax.random.choice(key, 50, (2,), replace=False))
    got = gmm.fit_gmm(torch.from_numpy(idx), torch.from_numpy(x), 2, 15)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    d = torch.Generator().manual_seed(0)
    drawn = gmm.draw_init_idx(d, 50, 2)
    assert drawn.shape == (2,) and drawn[0] != drawn[1]


def test_ot_distances_match_jax():
    rng = np.random.default_rng(4)

    def bank(k=3, g=2, d=5, shift=0.0):
        w = rng.random((k, g)).astype(np.float32) + 0.1
        return (w / w.sum(-1, keepdims=True),
                (rng.standard_normal((k, g, d)) + shift).astype(np.float32),
                (rng.random((k, g, d)) + 0.5).astype(np.float32))

    a, b = bank(), bank(shift=1.0)
    ca = np.asarray([5.0, 0.0, 9.0], np.float32)
    cb = np.asarray([3.0, 4.0, 1.0], np.float32)
    ga = [t[0] for t in a]
    gb = [t[1] for t in b]

    def jref(a_, ca_, b_, cb_, ga_, gb_):
        return (jot.dataset_distance(jgmm.GMM(*a_), ca_, jgmm.GMM(*b_), cb_,
                                     0.05),
                jot.mw2(jgmm.GMM(*ga_), jgmm.GMM(*gb_)))

    want, want_mw2 = jax.jit(jref)(a, ca, b, cb, ga, gb)
    got = ot.dataset_distance(gmm.GMM(*map(torch.from_numpy, a)),
                              torch.from_numpy(ca),
                              gmm.GMM(*map(torch.from_numpy, b)),
                              torch.from_numpy(cb), 0.05)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    np.testing.assert_allclose(
        float(ot.mw2(gmm.GMM(*map(torch.from_numpy, ga)),
                     gmm.GMM(*map(torch.from_numpy, gb)))),
        float(want_mw2), rtol=1e-4)
    dist = rng.random((4, 4)).astype(np.float32)
    dist = dist + dist.T
    np.fill_diagonal(dist, 0.0)
    np.testing.assert_allclose(
        _np(ot.distance_to_affinity(torch.from_numpy(dist))),
        np.asarray(jot.distance_to_affinity(jnp.asarray(dist))), rtol=2e-5)


def test_cka_matches_jax_with_its_probes():
    rng = np.random.default_rng(5)
    trees = [{"l0": {"C": rng.standard_normal((2, 4, 4)).astype(np.float32)},
              "l1": {"C": rng.standard_normal((4, 4)).astype(np.float32)}}
             for _ in range(5)]
    key = jax.random.key(97)
    probes = np.asarray(jax.random.normal(key, (16, 4), jnp.float32))
    jcs = jcka.stack_client_cs([jax.tree.map(jnp.asarray, t) for t in trees])
    jmoved = np.asarray(jcs).copy()
    jmoved[[1, 3]] += 0.3
    c = rng.standard_normal((3, 4, 4)).astype(np.float32)

    def jref(cs_, moved_, c_):
        full = jcka._pairwise_cka_stacked(cs_, key, 16)
        rows = jcka._refresh_rows(full, moved_, jnp.asarray([1, 3]), key, 16)
        return full, rows, jcka.pairwise_cka(c_, key, 16)

    want, want_rows, want_pair = jax.jit(jref)(jcs, jmoved, c)
    ttrees = [convert.params_from_numpy(t, "cpu") for t in trees]
    tprobes = torch.from_numpy(probes)
    got = cka.pairwise_model_similarity(ttrees, tprobes)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    cs = cka.stack_client_cs(ttrees)
    np.testing.assert_array_equal(_np(cs), np.asarray(jcs))
    # a row refresh after two clients moved
    got = cka.refresh_pairwise_cka(cka.refresh_pairwise_cka(
        None, cs, np.arange(5), tprobes), torch.from_numpy(jmoved),
        np.asarray([1, 3]), tprobes)
    np.testing.assert_allclose(_np(got), np.asarray(want_rows), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        _np(cka.pairwise_cka(torch.from_numpy(c), tprobes)),
        np.asarray(want_pair), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("participants,self_weight", [
    (None, 0.0), ([True, False, True, True], 0.0), (None, 0.25),
    ([False, True, False, False], 0.0)])
def test_personalized_weights_match_jax(participants, self_weight):
    sim = np.asarray([[1.0, 0.5, -0.2, 0.0], [0.5, 1.0, 0.3, 0.0],
                      [-0.2, 0.3, 1.0, -1.0], [0.0, 0.0, -1.0, 1.0]],
                     np.float32)
    part = None if participants is None else np.asarray(participants)
    want = jagg.personalized_weights(jnp.asarray(sim), self_weight,
                                     None if part is None
                                     else jnp.asarray(part))
    got = aggregation.personalized_weights(
        torch.from_numpy(sim), self_weight,
        None if part is None else torch.from_numpy(part))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(
        _np(aggregation.combined_similarity(torch.from_numpy(sim),
                                            torch.from_numpy(sim), 0.5)),
        np.asarray(jagg.combined_similarity(jnp.asarray(sim),
                                            jnp.asarray(sim), 0.5)))


@pytest.mark.parametrize("method", sorted(baselines.STRATEGIES))
def test_strategies_payloads_and_byte_ledgers_match_jax(tiny_params, method):
    """Per strategy: uplink trees (values and bytes), FedAvg/eqn-3
    aggregates and installed states, from the same numpy client states."""
    jcfg, params, _, _ = tiny_params
    rng = np.random.default_rng(6)
    m = 3
    clients = [{"adapter": jax.tree.map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.1).astype(
            np.float32), params["adapter"]),
        "head": rng.standard_normal((64, 3)).astype(np.float32)}
        for _ in range(m)]
    js, ts = jbase.get_strategy(method), baselines.get_strategy(method)
    assert (js.train_keys, js.uplink_keys, js.aggregate, js.dual, js.prox) \
        == (ts.train_keys, ts.uplink_keys, ts.aggregate, ts.dual, ts.prox)
    jstates = [js.init_state(jax.tree.map(jnp.asarray, c)) for c in clients]
    tstates = [ts.init_state(convert.params_from_numpy(c, "cpu"))
               for c in clients]
    for j, t in zip(jstates, tstates):
        _assert_trees_close(t, jax.tree.map(np.asarray, j), rtol=0, atol=0)
        _assert_trees_close(ts.effective_adapter(ts.trainable(t)),
                            jax.tree.map(np.asarray, js.effective_adapter(
                                js.trainable(j))), rtol=0, atol=0)
    jpay = [js.uplink(s) for s in jstates]
    tpay = [ts.uplink(s) for s in tstates]
    jrc = jcomm.round_comm_payloads([jpay[0], jpay[2]])
    trc = comm.round_comm_payloads([tpay[0], tpay[2]])
    assert (trc.uplink_bytes, trc.downlink_bytes, trc.uplink_elems) == \
        (jrc.uplink_bytes, jrc.downlink_bytes, jrc.uplink_elems)
    if ts.aggregate == "none":
        assert tpay == [None] * m
        return
    w = np.full((m, m), 0.5, np.float32)
    np.fill_diagonal(w, 0.0)
    part = np.asarray([True, False, True])
    jdown = js.server(jpay, sample_counts=[4, 9, 2], weights=jnp.asarray(w),
                      participants=jnp.asarray(part))
    tdown = ts.server(tpay, sample_counts=[4, 9, 2],
                      weights=torch.from_numpy(w),
                      participants=torch.from_numpy(part))
    for i in range(m):
        _assert_trees_close(ts.install(ts.after_local(tstates[i]), tdown[i]),
                            jax.tree.map(np.asarray, js.install(
                                js.after_local(jstates[i]), jdown[i])),
                            rtol=2e-6, atol=2e-6)
    if ts.prox:
        np.testing.assert_allclose(
            float(ts.local_penalty(ts.trainable(tstates[0]),
                                   {"w": tstates[1]["w"]})),
            float(js.local_penalty(js.trainable(jstates[0]),
                                   {"w": jstates[1]["w"]})), rtol=1e-5)


def test_tri_lora_payload_helpers_match_jax(tiny_params):
    _, params, _, _ = tiny_params
    tad = convert.params_from_numpy(params["adapter"], "cpu")
    assert tri_lora.payload_num_params(tad) == \
        jtri.payload_num_params(params["adapter"])
    assert tri_lora.full_lora_num_params(tad) == \
        jtri.full_lora_num_params(params["adapter"])
    _assert_trees_close(tri_lora.tree_payload(tad),
                        jtri.tree_payload(params["adapter"]), rtol=0, atol=0)
    c2 = jax.tree.map(lambda c: c * 2.0, jtri.tree_payload(params["adapter"]))
    _assert_trees_close(
        tri_lora.tree_load_payload(tad, convert.params_from_numpy(c2, "cpu")),
        jax.tree.map(np.asarray, jtri.tree_load_payload(params["adapter"],
                                                        c2)), rtol=0, atol=0)
    _assert_trees_close(
        tri_lora.tree_combine(tad, tad),
        jax.tree.map(np.asarray, jtri.tree_combine(params["adapter"],
                                                   params["adapter"])),
        rtol=0, atol=0)
