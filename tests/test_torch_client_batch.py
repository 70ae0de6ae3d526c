"""The port's stacked-client utilities against the JAX package's, on the
CPU: ``client_batch``, the stacked aggregators, comm and codec forms, the
stacked CKA, ``Strategy.server_stacked``, the device store and the
per-client clip of a stacked AdamW update.

Both packages get the same numpy trees (leaves with a leading client axis);
the codecs get the JAX package's stochastic-rounding uniforms, so every
stacked wire tree must match byte for byte.  Float results are held at
1e-6 (the same sums, taken in another order at most).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jaggregation
from repro.core import baselines as jbaselines
from repro.core import client_batch as jclient_batch
from repro.core import comm as jcomm
from repro.core import compress as jcompress
from repro.core.similarity import cka as jcka
from repro_torch import convert
from repro_torch.core import (aggregation, baselines, client_batch,
                              client_store, comm, compress)
from repro_torch.core.similarity import cka
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401

M = 4


def _tree(seed: int, m: int = M) -> dict:
    """A stacked adapter-like tree: (m, …) leaves of every codec tiling
    case (stacked layers, a leaf under one tile, an odd size, several
    tiles with a ragged last one)."""
    rng = np.random.default_rng(seed)
    shapes = {"groups": {"0": {"attn": {"wq": {"C": (2, 4, 4)}}}},
              "tail": ({"attn": {"wv": {"C": (4, 4)}}},),
              "odd": (3, 3), "long": (130,)}
    return jax.tree.map(
        lambda s: rng.standard_normal((m,) + s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple) and all(
            isinstance(v, int) for v in s))


def _t(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(jtree, ttree, atol=1e-6):
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(np.shape(a)) == tuple(b.shape)
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=atol)


def _rc(rc) -> tuple:
    return rc.uplink_bytes, rc.downlink_bytes, rc.uplink_elems


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def test_stack_select_gather_scatter_match_jax():
    states = [_tree(i, m=1) for i in range(M)]
    states = [jax.tree.map(lambda l: l[0], s) for s in states]
    jst = jclient_batch.stack_states(states)
    st = client_batch.stack_states([_t(s) for s in states])
    _close(jst, st, 0.0)
    assert client_batch.n_clients(st) == jclient_batch.n_clients(jst) == M
    for i in range(M):
        _close(jclient_batch.client_state(jst, i),
               client_batch.client_state(st, i), 0.0)
    for j, t in zip(jclient_batch.unstack_states(jst),
                    client_batch.unstack_states(st)):
        _close(j, t, 0.0)
    mask = np.array([True, False, True, False])
    other = _tree(9)
    _close(jclient_batch.select_clients(jnp.asarray(mask), jst, other),
           client_batch.select_clients(torch.from_numpy(mask), st,
                                       _t(other)), 0.0)
    ids = [3, 1]
    _close(jclient_batch.gather_clients(jst, ids),
           client_batch.gather_clients(st, ids), 0.0)
    vals = _tree(11, m=2)
    _close(jclient_batch.scatter_clients(jst, ids, vals),
           client_batch.scatter_clients(st, ids, _t(vals)), 0.0)
    one = jax.tree.map(lambda l: l[0], _tree(12))
    _close(jclient_batch.broadcast_to_clients(one, M),
           client_batch.broadcast_to_clients(_t(one), M), 0.0)


@pytest.mark.parametrize("participants", [None, [True, False, True, True],
                                          [False, True, False, False]])
def test_stacked_aggregators_match_jax(participants):
    payload = _tree(1)
    w = np.random.default_rng(2).random((M, M)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    counts = [10, 0, 30, 5]
    pj = None if participants is None else jnp.asarray(participants)
    pt = None if participants is None else torch.tensor(participants)
    _close(jaggregation.aggregate_stacked(payload, jnp.asarray(w)),
           aggregation.aggregate_stacked(_t(payload), torch.from_numpy(w)))
    _close(jaggregation.fedavg_stacked(payload, counts, pj),
           aggregation.fedavg_stacked(_t(payload), counts, pt))
    # the list forms are the stacked forms of the stacked list
    listed = client_batch.unstack_states(_t(payload))
    _close(jaggregation.fedavg_stacked(payload, counts, pj),
           aggregation.fedavg(listed, counts, pt))


@pytest.mark.parametrize("method", sorted(jbaselines.STRATEGIES))
def test_server_stacked_matches_jax(method):
    payload = _tree(3)
    w = np.random.default_rng(4).random((M, M)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    mask = [True, True, False, True]
    kw = dict(sample_counts=[4, 8, 2, 6], weights=None,
              participants=None)
    jstrat, strat = jbaselines.get_strategy(method), baselines.get_strategy(
        method)
    if strat.aggregate == "personalized":
        jkw = dict(kw, weights=jnp.asarray(w), participants=jnp.asarray(mask))
        tkw = dict(kw, weights=torch.from_numpy(w),
                   participants=torch.tensor(mask))
    else:
        jkw = dict(kw, participants=jnp.asarray(mask))
        tkw = dict(kw, participants=torch.tensor(mask))
    want = jstrat.server_stacked(payload, **jkw)
    got = strat.server_stacked(_t(payload), **tkw)
    if want is None:
        assert got is None
    else:
        _close(want, got)


def test_stacked_comm_matches_jax():
    payload = _tree(5)
    tp = _t(payload)
    assert comm.stacked_per_client_bytes(tp) == \
        jcomm.stacked_per_client_bytes(payload)
    assert comm.stacked_per_client_elems(tp) == \
        jcomm.stacked_per_client_elems(payload)
    assert comm.per_client_comm(tp) == jcomm.per_client_comm(payload)
    assert comm.per_client_comm(None) == (0, 0)
    assert _rc(comm.round_comm_stacked(tp, 3)) == _rc(
        jcomm.round_comm_stacked(payload, 3))
    ragged = {"a": torch.zeros(M, 3), "b": torch.zeros(5)}
    with pytest.raises(ValueError, match="ragged"):
        comm.stacked_per_client_elems(ragged)


def _jax_keys_uniforms(codec_name: str, tree, seed: int, rnd: int) -> list:
    """Client i's uniforms as ``compress.encode`` draws them from
    ``client_key(seed, rnd, i)`` for one client's slice of ``tree``."""
    codec = jcompress.get_codec(codec_name)
    leaves = jax.tree.leaves(jax.tree.map(lambda l: l[0], tree))
    out = []
    for i in range(M):
        keys = jax.random.split(jcompress.client_key(seed, rnd, i),
                                len(leaves))
        per = []
        for leaf, k in zip(leaves, keys):
            n = int(np.prod(np.shape(leaf)))
            tile = jcompress._leaf_tile(n, codec.pack)
            per.append(torch.from_numpy(np.array(
                jax.random.uniform(k, (-(-n // tile), tile)))))
        out.append(per)
    return out


@pytest.mark.parametrize("codec_name", ["bf16", "int8", "int4"])
def test_encode_stacked_matches_jax(codec_name):
    seed, rnd = 7, 2
    payload, ef = _tree(6), jax.tree.map(lambda l: 0.1 * l, _tree(8))
    codec, jcodec = compress.get_codec(codec_name), jcompress.get_codec(
        codec_name)
    jenc, jdec, jef = jax.jit(lambda p, e, k: jcompress.encode_stacked(
        jcodec, p, e, k))(payload, ef, jcompress.client_keys(seed, rnd, M))
    us = _jax_keys_uniforms(codec_name, payload, seed, rnd)
    enc, dec, ef_new = compress.encode_stacked(codec, _t(payload), _t(ef),
                                               us)
    jl, tl = jax.tree.leaves(jenc), tree_leaves(enc)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(np.shape(a)) == tuple(b.shape)
        assert _bits(a) == _bits(b)
    _close(jdec, dec)
    _close(jef, ef_new)
    _close(jcompress.decode_stacked(jcodec, jenc, payload),
           compress.decode_stacked(codec, enc, _t(payload)))
    # each client's slice is bit for bit the loop path's encode_client
    for i in range(M):
        e1, d1, f1 = compress.encode_client(
            codec, client_batch.client_state(_t(payload), i),
            client_batch.client_state(_t(ef), i), us[i])
        for a, b in zip(tree_leaves(e1), tree_leaves(
                client_batch.client_state(enc, i))):
            assert _bits(a) == _bits(b)
    # the wire structure from shapes alone prices what the encode priced
    struct = compress.wire_struct(codec, _t(payload), M)
    assert all(t.device.type == "meta" for t in tree_leaves(struct))
    st = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype),
                      payload)
    assert comm.per_client_comm(struct) == jcomm.per_client_comm(
        jcompress.wire_struct(jcodec, st, M))
    assert _rc(comm.round_comm_compressed_stacked(enc, _t(payload), 3)) \
        == _rc(jcomm.round_comm_compressed_stacked(jenc, payload, 3))


def test_stacked_cka_matches_jax():
    rng = np.random.default_rng(13)
    c_tree = {"groups": {"wq": rng.standard_normal((M, 3, 4, 4)).astype(
        np.float32)}, "tail": (rng.standard_normal((M, 4, 4)).astype(
            np.float32),)}
    key = jax.random.key(99)
    probes = np.array(jax.random.normal(key, (16, 4), jnp.float32))
    jcs = jcka.stacked_cs(c_tree)
    cs = cka.stacked_cs(_t(c_tree))
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs))
    np.testing.assert_allclose(
        cka.pairwise_model_similarity_stacked(
            _t(c_tree), torch.from_numpy(probes)).numpy(),
        np.asarray(jcka.pairwise_model_similarity_stacked(c_tree, key, 16)),
        atol=1e-5)
    # the stacked form is the list form of the unstacked trees
    trees = client_batch.unstack_states(_t(c_tree))
    torch.testing.assert_close(cka.stack_client_cs(trees), cs)


def test_stacked_adamw_clips_each_client_by_its_own_norm():
    rng = np.random.default_rng(21)
    params = _t({"a": rng.standard_normal((M, 3, 5)).astype(np.float32),
                 "b": rng.standard_normal((M, 7)).astype(np.float32)})
    grads = _t({"a": rng.standard_normal((M, 3, 5)).astype(np.float32)
                * np.array([0.1, 10, 1, 100], np.float32)[:, None, None],
                "b": rng.standard_normal((M, 7)).astype(np.float32)})
    opt = adamw(lr=1e-2, grad_clip=1.0, weight_decay=0.1, stacked=True)
    upd, state = opt.update(grads, opt.init(params), params)
    one = adamw(lr=1e-2, grad_clip=1.0, weight_decay=0.1)
    for i in range(M):
        p_i = client_batch.client_state(params, i)
        u_i, s_i = one.update(client_batch.client_state(grads, i),
                              one.init(p_i), p_i)
        for a, b in zip(tree_leaves(u_i),
                        tree_leaves(client_batch.client_state(upd, i))):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    assert state["step"] == 1


def test_device_store_and_unported_stores():
    states = [_t(jax.tree.map(lambda l: l[0], _tree(i, m=1)))
              for i in range(M)]
    store = client_store.make_store("device", states)
    assert store.m == M and store.backend == "device"
    _close(jclient_batch.stack_states(
        [jax.tree.map(lambda t: t.numpy(), s) for s in states]),
        store.resident(), 0.0)
    store.scatter([2], client_batch.gather_clients(store.resident(), [0]))
    for a, b in zip(tree_leaves(store.unstack()[2]),
                    tree_leaves(states[0])):
        torch.testing.assert_close(a, b)
    store.adopt(tree_map(lambda t: t * 2, store.resident()))
    # the client axis over the mesh (it raised until the mesh layer was
    # ported): every store holds the device store's stack
    for backend, kw in (("host", {"parallelism": "shard"}), ("sharded", {}),
                        ("device", {"parallelism": "shard"})):
        other = client_store.make_store(backend, states, **kw)
        held = (other.population if backend == "host"
                else other.resident())
        _close(jclient_batch.stack_states(
            [jax.tree.map(lambda t: t.numpy(), s) for s in states]), held,
            0.0)
    with pytest.raises(ValueError):
        client_store.make_store("disk", states)
