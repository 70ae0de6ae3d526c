"""The port's checkpoints against the JAX package's, on the CPU: a file
written by either package restores in the other, bit for bit (a bf16 leaf
included), and a truncated or corrupted file raises ``ValueError`` in
both."""
import io
import struct
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as ckpt
from repro_torch import convert

META = {"arch": "fed-100m", "rounds": 3, "method": "celora"}


def _numpy_tree() -> dict:
    """An adapter-like tree: stacked f32 factors, a bf16 leaf, int32 and
    uint8 leaves, a tuple and an empty tuple."""
    rng = np.random.default_rng(0)
    return {"adapter_client0": {
        "groups": {"0": {"attn": {
            "wq": {"A": rng.standard_normal((2, 16, 4)).astype(np.float32),
                   "C": np.eye(4, dtype=np.float32)[None].repeat(2, 0),
                   "B": rng.standard_normal((2, 4, 8)).astype(np.float32)}}}},
        "tail": ()},
        "scales": jnp.asarray(rng.standard_normal(5), jnp.bfloat16),
        "codes": (rng.integers(-127, 128, (3, 4)).astype(np.int8),
                  rng.integers(0, 255, (2,)).astype(np.uint8)),
        "step": np.asarray(7, np.int32)}


def _jax_tree():
    return jax.tree.map(jnp.asarray, _numpy_tree())


def _port_tree():
    return convert.params_from_numpy(_numpy_tree(), "cpu")


def _assert_same(jtree, ttree) -> None:
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(ttree)[0]}
    assert len(jl) == len(tl)
    for path, j in jl:
        t = tl[jax.tree_util.keystr(path)]
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


def test_port_checkpoint_restores_in_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    ckpt.save(path, _port_tree(), metadata=META)
    jckpt.ckpt.verify(path)
    back = jckpt.restore(path, _jax_tree())
    _assert_same(back, _port_tree())
    assert jckpt.metadata(path) == META
    sub = jckpt.ckpt.load_subtree(path, "adapter_client0/groups")
    np.testing.assert_array_equal(sub["0"]["attn"]["wq"]["B"],
                                  _numpy_tree()["adapter_client0"]["groups"]
                                  ["0"]["attn"]["wq"]["B"])


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, _jax_tree(), metadata=META)
    ckpt.verify(path)
    back = ckpt.restore(path, _port_tree())
    _assert_same(_jax_tree(), back)
    assert back["scales"].dtype == torch.bfloat16
    assert ckpt.metadata(path) == META
    sub = ckpt.load_subtree(path, "adapter_client0")
    assert sub["groups"]["0"]["attn"]["wq"]["C"].shape == (2, 4, 4)
    assert ckpt.load_subtree(path, "nothing") == {}


def test_restore_refuses_another_structure(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save(path, _port_tree())
    wrong = _port_tree()
    wrong["step"] = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, wrong)
    wrong = _port_tree()
    wrong["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="extra"):
        ckpt.restore(path, wrong)
    meta = dict(META)
    ckpt.check_fingerprint(path, meta, {"arch": "fed-100m"})
    with pytest.raises(ValueError, match="method"):
        ckpt.check_fingerprint(path, meta, {"method": "fedavg"})


def _last_data_byte(raw: bytearray, member: str) -> int:
    """Offset of the last byte of ``member``'s array data in the npz (the
    files are stored uncompressed): a flip there changes a leaf's value."""
    info = zipfile.ZipFile(io.BytesIO(bytes(raw))).getinfo(member)
    name_len, extra_len = struct.unpack_from("<HH", raw,
                                             info.header_offset + 26)
    return (info.header_offset + 30 + name_len + extra_len
            + info.compress_size - 1)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_damaged_file_raises_in_both_packages(tmp_path, writer, damage):
    path = tmp_path / "c.npz"
    if writer == "port":
        ckpt.save(str(path), _port_tree(), metadata=META)
    else:
        jckpt.save(str(path), _jax_tree(), metadata=META)
    raw = bytearray(path.read_bytes())
    if damage == "truncate":
        raw = raw[:len(raw) // 2]
    else:
        raw[_last_data_byte(raw, "adapter_client0/groups/0/attn/wq/B.npy")] \
            ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        ckpt.restore(str(path), _port_tree())
    with pytest.raises(ValueError):
        jckpt.restore(str(path), _jax_tree())
