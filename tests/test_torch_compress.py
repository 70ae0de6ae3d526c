"""The port's uplink codecs and compressed byte ledger against the JAX
package's, on the CPU.

The port is handed the JAX package's stochastic-rounding uniforms (drawn
from ``compress.client_key`` exactly as ``compress.encode`` draws them),
so every wire tree must match byte for byte: codes, bf16 scales, dtypes
and shapes.  Decoding, the error-feedback residual and the round's byte
accounting must then match exactly too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as jcomm
from repro.core import compress as jcompress
from repro_torch import convert
from repro_torch.core import comm, compress
from torch_threads import one_torch_thread  # noqa: F401

CODECS = ("none", "bf16", "int8", "int4")


def _payload(seed: int) -> dict:
    """A nested payload with leaves of every tiling case: one exact tile,
    stacked layers, a leaf smaller than a tile, an odd size (int4 pads to
    even), and a leaf spanning several tiles with a ragged last one."""
    rng = np.random.default_rng(seed)
    shapes = {"groups": {"0": {"attn": {"wq": (8, 8), "wv": (2, 4, 4)}}},
              "head": (5,), "odd": (3, 3), "long": (130,)}
    return jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                        shapes, is_leaf=lambda s: isinstance(s, tuple))


def _jax_uniforms(codec_name: str, tree, key) -> list:
    """The uniforms ``compress.encode`` draws for ``tree`` under ``key``,
    one (n_tiles, tile) array per leaf in the JAX package's leaf order."""
    codec = jcompress.get_codec(codec_name)
    leaves = jax.tree.leaves(tree)
    keys = jax.random.split(key, len(leaves))
    out = []
    for leaf, k in zip(leaves, keys):
        n = int(np.prod(np.shape(leaf)))
        tile = jcompress._leaf_tile(n, codec.pack)
        out.append(torch.from_numpy(np.array(
            jax.random.uniform(k, (-(-n // tile), tile)))))
    return out


def _bits(x) -> np.ndarray:
    """Raw bytes of a JAX array or a port tensor (bf16 included)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _assert_same_wire(j_enc, t_enc) -> None:
    jl = jax.tree_util.tree_flatten_with_path(j_enc)[0]
    tl = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(t_enc)[0]}
    assert len(jl) == len(tl)
    for path, j in jl:
        t = tl[jax.tree_util.keystr(path)]
        assert _dtype_name(t) == _dtype_name(j), path
        assert tuple(t.shape) == tuple(j.shape), path
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=str(path))


@pytest.mark.parametrize("codec_name", CODECS)
def test_wire_decode_and_residual_match_jax_byte_for_byte(codec_name):
    payload = _payload(0)
    ef = jax.tree.map(lambda l: 0.1 * l, _payload(1))    # a live residual
    key = jcompress.client_key(7, 3, 2)
    jcodec = jcompress.get_codec(codec_name)
    j_enc, j_served, j_ef = jcompress.encode_client(
        jcodec, jax.tree.map(jnp.asarray, payload),
        jax.tree.map(jnp.asarray, ef), key)

    codec = compress.get_codec(codec_name)
    v = jax.tree.map(lambda p, e: p + e, payload, ef)
    t_enc, t_served, t_ef = compress.encode_client(
        codec, convert.params_from_numpy(payload, "cpu"),
        convert.params_from_numpy(ef, "cpu"),
        _jax_uniforms(codec_name, v, key))

    _assert_same_wire(j_enc, t_enc)
    for j, t in ((j_served, t_served), (j_ef, t_ef)):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), b.numpy()), j, t)
    j_rc = jcomm.round_comm_compressed_payloads([j_enc, j_enc],
                                                [payload, payload])
    t_rc = comm.round_comm_compressed_payloads(
        [t_enc, t_enc], [convert.params_from_numpy(payload, "cpu")] * 2)
    assert (t_rc.uplink_bytes, t_rc.downlink_bytes, t_rc.uplink_elems) == \
        (j_rc.uplink_bytes, j_rc.downlink_bytes, j_rc.uplink_elems)


@pytest.mark.parametrize("codec_name", ("int8", "int4"))
def test_residual_telescopes_over_rounds_like_jax(codec_name):
    """Three rounds of error feedback on a drifting payload: the port's
    residual after each round equals the JAX package's, and Σ served =
    Σ payload − e_T."""
    jcodec, codec = (jcompress.get_codec(codec_name),
                     compress.get_codec(codec_name))
    j_ef = jcompress.init_ef(jax.tree.map(jnp.asarray, _payload(0)))
    t_ef = compress.init_ef(convert.params_from_numpy(_payload(0), "cpu"))
    total_p = total_s = 0.0
    for rnd in range(3):
        payload = _payload(10 + rnd)
        key = jcompress.client_key(0, rnd, 1)
        v = jax.tree.map(lambda p, e: p + np.asarray(e), payload, j_ef)
        _, _, j_ef = jcompress.encode_client(
            jcodec, jax.tree.map(jnp.asarray, payload), j_ef, key)
        _, served, t_ef = compress.encode_client(
            codec, convert.params_from_numpy(payload, "cpu"), t_ef,
            _jax_uniforms(codec_name, v, key))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), b.numpy()), j_ef, t_ef)
        total_p += payload["long"].astype(np.float64)
        total_s += served["long"].double().numpy()
    np.testing.assert_allclose(total_s, total_p - t_ef["long"].numpy(),
                               atol=1e-5)


def test_generator_uniforms_are_seeded_and_shaped():
    codec = compress.get_codec("int4")
    tree = convert.params_from_numpy(_payload(0), "cpu")
    a = compress.encode(codec, tree, compress.client_generator(0, 1, 2))
    b = compress.encode(codec, tree, compress.client_generator(0, 1, 2))
    c = compress.encode(codec, tree, compress.client_generator(0, 1, 3))
    same = [torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(a["codes"]), jax.tree.leaves(b["codes"]))]
    assert all(same)
    assert not all(torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(a["codes"]), jax.tree.leaves(c["codes"])))
    with pytest.raises(ValueError, match="uniforms"):
        compress.encode(codec, tree, [torch.zeros(1, 2)])
    with pytest.raises(ValueError, match="uplink_codec"):
        compress.get_codec("fp4")
