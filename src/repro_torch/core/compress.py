"""Quantized uplink compression with error feedback: PyTorch port of the
per-client (list) half of ``repro.core.compress``.

The uplink payload is encoded with a lossy codec before it crosses the
wire, the server dequantizes before aggregating, and the byte accounting
(:mod:`.comm`) prices the ENCODED tree (codes plus scales).

Codecs (``uplink_codec``):

* ``"none"`` — identity; the runtimes keep their uncompressed path.
* ``"bf16"`` — round-to-nearest bfloat16 cast, no scales.
* ``"int8"`` — per-tile absmax scale (stored bf16) and stochastic rounding
  ``floor(t/s + u)`` to codes in [-127, 127].
* ``"int4"`` — as int8 with codes in [-7, 7], two per byte (the even
  element in the low nibble).

Wire format of an int codec, per payload leaf: the leaf is flattened,
padded with zeros to whole tiles of ``min(TILE, n)`` elements (int4 rounds
the tile up to even), and shipped as ``{"codes": int8 | uint8 (n_tiles,
tile[/2]), "scales": bf16 (n_tiles,)}``.  Leaves are visited in the JAX
package's order (dict keys sorted), so a tree encodes to the same wire
bytes in both packages given the same uniforms.

The uniforms ``u ~ U[0, 1)`` of the stochastic rounding come either from a
``torch.Generator`` (:func:`client_generator`, seeded from (seed, round,
client), drawn on the CPU so every device draws the same numbers) or
ready-made as one tensor per leaf, of the leaf's (n_tiles, tile) shape, in
that order.  The JAX package draws them from a threefry key per (round,
client) (``compress.client_key``); tests hand the port those numbers.

Error feedback: a communicating client carries a residual ``e`` (the
payload's structure, f32).  Per round it uplinks ``Q(payload + e)`` and
keeps ``e' = (payload + e) − dequant``; the caller installs ``e'`` only for
a delivered upload.

Stacked forms (the vectorized runtime, every leaf with a leading client
axis m): :func:`encode_stacked` quantizes every client's slice of a leaf
at once, each slice as the loop path quantizes that client's leaf, with
client i's uniforms drawn from its own generator
(:func:`client_generator` (seed, round, i)), so loop and vectorized runs
encode bit for bit alike.  :func:`stacked_uniforms` draws those uniforms
ahead of the round (the scan engine draws a chunk's on its producer thread
and hands them to :func:`encode_stacked` ready, on the device).
:func:`wire_struct` gives the stacked wire tree as meta tensors, its bytes
reckoned from shapes alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.tree import tree_leaves, tree_map

# Tile extent for per-tile scales (elements of the flattened leaf).
TILE = 64

# Tag separating the codec's draws from every other seed-derived stream
# (the JAX package folds the same constant into its key).
_KEY_TAG = 0x51C0DE

Uniforms = Union[torch.Generator, Sequence[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Codec:
    """One uplink codec.  ``qmax`` is the integer code range (None for the
    cast codecs); ``pack`` packs two 4-bit codes per byte."""
    name: str
    qmax: Optional[int] = None
    pack: bool = False

    @property
    def is_identity(self) -> bool:
        return self.name == "none"


CODECS: dict[str, Codec] = {
    "none": Codec("none"),
    "bf16": Codec("bf16"),
    "int8": Codec("int8", qmax=127),
    "int4": Codec("int4", qmax=7, pack=True),
}


def get_codec(name: str) -> Codec:
    if name not in CODECS:
        raise ValueError(f"unknown uplink_codec {name!r}; "
                         f"known: {sorted(CODECS)}")
    return CODECS[name]


# ---------------------------------------------------------------------------
# per-leaf quantize / dequantize
# ---------------------------------------------------------------------------

def _leaf_tile(n: int, pack: bool) -> int:
    """Tile extent for an n-element leaf: TILE, shrunk to the leaf when it
    is smaller, rounded up to even for the nibble-packed codec."""
    if pack:
        return min(TILE, n + (n % 2))
    return min(TILE, n)


def _tile_shape(n: int, pack: bool) -> tuple[int, int]:
    """(n_tiles, tile) of an n-element leaf: the shape of its uniforms."""
    tile = _leaf_tile(n, pack)
    return -(-n // tile), tile


def _quant_leaf(x: torch.Tensor, u: torch.Tensor, qmax: int, pack: bool,
                lead: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf → (codes, scales).  codes: int8 (n_tiles, tile), or uint8
    (n_tiles, tile/2) nibble-packed; scales: bf16 (n_tiles,).  The first
    ``lead`` axes (a stacked leaf's client axis) are kept in front of both:
    each slice is quantized as a leaf of its own."""
    batch = tuple(x.shape[:lead])
    n = int(np.prod(x.shape[lead:]))
    n_tiles, tile = _tile_shape(n, pack)
    flat = x.reshape(batch + (n,)).float()
    padding = n_tiles * tile - n
    if padding:
        flat = torch.cat([flat, flat.new_zeros(batch + (padding,))], dim=-1)
    t = flat.reshape(batch + (n_tiles, tile))
    amax = t.abs().amax(dim=-1)
    scales = (amax / qmax).to(torch.bfloat16)             # the STORED scale
    s = scales.float().clamp_min(1e-12)[..., None]
    codes = torch.floor(t / s + u.to(t.device)).clamp(-qmax, qmax).to(
        torch.int8)
    if pack:
        lo = codes[..., 0::2].to(torch.uint8) & 0xF
        hi = (codes[..., 1::2].to(torch.uint8) & 0xF) << 4
        codes = lo | hi
    return codes, scales


def _dequant_leaf(codes: torch.Tensor, scales: torch.Tensor, shape: tuple,
                  pack: bool, lead: int = 0) -> torch.Tensor:
    """Inverse of :func:`_quant_leaf` (up to the quantization error)."""
    if pack:
        lo = (codes & 0xF).to(torch.int32)
        hi = (codes >> 4).to(torch.int32)
        lo = torch.where(lo > 7, lo - 16, lo)             # sign-extend
        hi = torch.where(hi > 7, hi - 16, hi)
        c = torch.stack([lo, hi], dim=-1).reshape(codes.shape[:-1] + (-1,))
    else:
        c = codes.to(torch.int32)
    vals = c.float() * scales.float()[..., None]
    batch = tuple(shape[:lead])
    n = int(np.prod(shape[lead:]))
    return vals.reshape(batch + (-1,))[..., :n].reshape(shape)


# ---------------------------------------------------------------------------
# tree-level encode / decode
# ---------------------------------------------------------------------------

def _sorted_tree(tree: Any) -> Any:
    """The same tree with every dict's keys in sorted order, so that
    :func:`repro_torch.tree.tree_leaves` visits the leaves in the JAX
    package's order."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_sorted_tree(v) for v in tree)
    return tree


def client_generator(seed: int, rnd: int, i: int) -> torch.Generator:
    """The CPU generator of client ``i``'s round-``rnd`` uniforms."""
    state = np.random.SeedSequence([seed, _KEY_TAG, rnd, i]).generate_state(2)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


def _leaf_uniforms(codec: Codec, tree: Any, u: Uniforms) -> list:
    """Per leaf of ``tree`` (in sorted order), its (n_tiles, tile) f32
    uniforms: drawn from ``u`` if it is a generator, else ``u`` itself."""
    leaves = tree_leaves(_sorted_tree(tree))
    shapes = [_tile_shape(int(l.numel()), codec.pack) for l in leaves]
    if isinstance(u, torch.Generator):
        return [torch.rand(sh, generator=u, dtype=torch.float32)
                for sh in shapes]
    u = list(u)
    if len(u) != len(leaves) or any(tuple(x.shape) != sh
                                    for x, sh in zip(u, shapes)):
        raise ValueError(f"uniforms {[tuple(x.shape) for x in u]} do not "
                         f"match the leaves' tiles {shapes}")
    return [x.float() for x in u]


def _encode(codec: Codec, tree: Any, leaf_u, lead: int) -> dict:
    """The wire tree of ``tree``, with ``leaf_u(sorted tree)`` the int
    codecs' per-leaf uniforms and ``lead`` kept leading axes."""
    if codec.is_identity:
        return {"codes": tree, "scales": {}}
    if codec.name == "bf16":
        return {"codes": tree_map(lambda l: l.to(torch.bfloat16), tree),
                "scales": {}}
    tree = _sorted_tree(tree)
    quantized = [_quant_leaf(l, us, codec.qmax, codec.pack, lead)
                 for l, us in zip(tree_leaves(tree), leaf_u(tree))]
    codes = iter([c for c, _ in quantized])
    scales = iter([s for _, s in quantized])
    return {"codes": tree_map(lambda _: next(codes), tree),
            "scales": tree_map(lambda _: next(scales), tree)}


def encode(codec: Codec, tree: Any, u: Uniforms) -> dict:
    """Encode ONE client's payload tree → ``{"codes": …, "scales": …}`` (the
    wire tree: :func:`.comm.tree_bytes` of it IS the uplink cost).  The
    cast codecs carry no scales (an empty subtree); ``u`` is read by the
    int codecs only."""
    return _encode(codec, tree, lambda t: _leaf_uniforms(codec, t, u), 0)


def decode(codec: Codec, enc: dict, like: Any, lead: int = 0) -> Any:
    """Decode a wire tree back to the structure and dtypes of ``like`` —
    what the SERVER aggregates (``lead``: kept leading axes)."""
    if codec.is_identity:
        return enc["codes"]
    if codec.name == "bf16":
        return tree_map(lambda c, l: c.to(l.dtype), enc["codes"], like)
    return tree_map(lambda c, s, l: _dequant_leaf(
        c, s, tuple(l.shape), codec.pack, lead).to(l.dtype),
        enc["codes"], enc["scales"], like)


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------

def init_ef(payload: Any) -> Any:
    """Fresh error-feedback residual: zeros, payload structure, f32."""
    return tree_map(lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                          device=l.device), payload)


def encode_client(codec: Codec, payload: Any, ef: Any, u: Uniforms
                  ) -> tuple[dict, Any, Any]:
    """One client's error-compensated uplink step:

        v = payload + e;  wire = Q(v);  served = dequant(wire);
        e' = v − served

    Returns ``(wire, served, e')``.  The caller prices bytes on ``wire``,
    aggregates ``served`` and installs ``e'`` only if the upload was
    delivered (a participant)."""
    v = tree_map(lambda p, e: p.float() + e, payload, ef)
    enc = encode(codec, v, u)
    dec = decode(codec, enc, v)
    ef_new = tree_map(lambda a, b: a - b, v, dec)
    return enc, dec, ef_new


def stacked_uniforms(codec: Codec, tree: Any, us: Sequence[Uniforms]
                     ) -> list:
    """Per leaf of the stacked ``tree`` (leaves (m, …), dict keys sorted),
    the (m, n_tiles, tile) f32 uniforms: client i's row drawn from
    ``us[i]`` exactly as :func:`encode` draws them for client i alone.
    Only the leaves' shapes are read, so ``tree`` may hold meta tensors."""
    m = int(tree_leaves(tree)[0].shape[0])
    if len(us) != m:
        raise ValueError(f"{len(us)} uniform sources for {m} clients")
    rows = [_leaf_uniforms(codec, tree_map(lambda t, i=i: t[i], tree), u)
            for i, u in enumerate(us)]
    return [torch.stack(per_leaf) for per_leaf in zip(*rows)]


def encode_stacked(codec: Codec, payload: Any, ef: Any,
                   us: Optional[Sequence[Uniforms]] = None, *,
                   uniforms: Optional[Sequence[torch.Tensor]] = None
                   ) -> tuple[dict, Any, Any]:
    """Stacked form of :func:`encode_client`: ``payload`` and ``ef`` carry a
    leading client axis (m, …) and ``us`` holds client i's uniform source
    at i — or ``uniforms`` holds them drawn already, as
    :func:`stacked_uniforms` gives them.  Returns the stacked (wire,
    served, e'), each client's slice bit for bit what :func:`encode_client`
    gives that client."""
    v = tree_map(lambda p, e: p.float() + e, payload, ef)
    enc = _encode(codec, v, (lambda t: stacked_uniforms(codec, t, us))
                  if uniforms is None else (lambda t: list(uniforms)), 1)
    dec = decode(codec, enc, v, lead=1)
    ef_new = tree_map(lambda a, b: a - b, v, dec)
    return enc, dec, ef_new


def decode_stacked(codec: Codec, enc: dict, like: Any) -> Any:
    """Row-wise :func:`decode` of a stacked wire tree (every leaf with a
    leading client axis)."""
    return decode(codec, enc, like, lead=1)


def wire_struct(codec: Codec, payload_struct: Any, m: int) -> dict:
    """The stacked wire tree of a stacked payload of m clients as meta
    tensors (no data, no device work): its bytes, by
    :func:`.comm.per_client_comm`, are the per-client uplink cost, reckoned
    from shapes alone.  ``payload_struct`` may be meta tensors or real
    ones; only shapes and dtypes are read."""
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), payload_struct)
    if int(tree_leaves(meta)[0].shape[0]) != m:
        raise ValueError(f"payload_struct's client axis is not m={m}")

    def leaf_u(tree):
        return [torch.empty((m,) + _tile_shape(
            int(np.prod(l.shape[1:])), codec.pack), device="meta")
            for l in tree_leaves(tree)]
    return _encode(codec, tree_map(lambda t: t.float(), meta), leaf_u, 1)


def per_client_traffic(codec: Codec, payload_struct: Any, m: int,
                       compressed: bool) -> tuple[int, int, int]:
    """(uplink bytes, uplink elements, downlink bytes) of one client's
    round, from the shapes of a stacked payload of m clients alone: the
    uplink priced on the ENCODED tree when ``compressed``, the downlink on
    the raw payload (the server sends full-precision aggregates).  A
    ``None`` payload (no uplink) costs nothing."""
    if payload_struct is None:
        return 0, 0, 0
    raw_b, raw_e = comm.per_client_comm(payload_struct)
    if not compressed:
        return raw_b, raw_e, raw_b
    up_b, up_e = comm.per_client_comm(wire_struct(codec, payload_struct, m))
    return up_b, up_e, raw_b
