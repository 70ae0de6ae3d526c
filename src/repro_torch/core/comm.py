"""Exact per-round communication accounting (the paper's Table-III metric,
in BYTES of the real payload trees): PyTorch port of the list-form half of
``repro.core.comm``.

Every number is ``Σ leaf.numel() · leaf.element_size()`` over the payload
tree a strategy uplinks, so a run's byte ledger equals the JAX package's
for the same strategy, model and participation.  Per round each
participant uplinks one payload and receives a downlink of the same
structure; stragglers and strategies with ``aggregate="none"`` cost
nothing.  Under an uplink codec (:mod:`.compress`) the uplink is priced on
the ENCODED wire tree (codes and scales) and the downlink on the raw
payload: the server broadcasts full-precision aggregates.  The stacked
forms price one client's slice of a stacked payload (leaves (m, …), the
vectorized paths' layout) times the participants.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import tree_leaves


def leaf_bytes(leaf: torch.Tensor) -> int:
    """numel · element size of one tensor."""
    return int(leaf.numel()) * leaf.element_size()


def tree_bytes(tree: Any) -> int:
    """Exact wire bytes of a payload tree: Σ leaf.numel · element size."""
    return sum(leaf_bytes(t) for t in tree_leaves(tree))


def tree_elems(tree: Any) -> int:
    """Dtype-blind element count (the JAX package's ``uplink_elems``)."""
    return sum(int(t.numel()) for t in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class RoundComm:
    """One round's exact wire traffic, summed over participants."""
    uplink_bytes: int
    downlink_bytes: int
    uplink_elems: int

    @staticmethod
    def zero() -> "RoundComm":
        return RoundComm(0, 0, 0)


def _per_client(total: int, stacked: Any, unit: str) -> int:
    """``total`` over the leading client axis m of ``stacked``'s leaves; a
    ragged tree (some leaf without the m axis) leaves a remainder and
    raises."""
    leaves = tree_leaves(stacked)
    m = int(leaves[0].shape[0])
    if total % m != 0:
        raise ValueError(
            f"ragged stacked payload: total {unit} {total} not divisible by "
            f"leading client axis m={m}; leaf shapes "
            f"{[tuple(t.shape) for t in leaves]}")
    return total // m


def stacked_per_client_bytes(stacked: Any) -> int:
    """Per-client payload bytes of a STACKED payload (leaves (m, …))."""
    if not tree_leaves(stacked):
        return 0
    return _per_client(tree_bytes(stacked), stacked, "bytes")


def stacked_per_client_elems(stacked: Any) -> int:
    """Per-client element count of a STACKED payload (leaves (m, …))."""
    if not tree_leaves(stacked):
        return 0
    return _per_client(tree_elems(stacked), stacked, "elems")


def per_client_comm(payload: Any) -> tuple[int, int]:
    """(bytes, elems) of ONE client's slice of a stacked payload — or of a
    tree of meta tensors of its shape (:func:`.compress.wire_struct`), so
    that traffic is priced from shapes alone.  ``None`` costs (0, 0)."""
    if payload is None:
        return 0, 0
    return stacked_per_client_bytes(payload), stacked_per_client_elems(
        payload)


def round_comm_stacked(payload: Any, n_participants: int) -> RoundComm:
    """Accounting from ONE stacked payload tree (the vectorized server
    layout): only the ``n_participants`` client slices cross the wire, up
    and (mirrored) down."""
    if payload is None:
        return RoundComm.zero()
    per_b, per_e = per_client_comm(payload)
    return RoundComm(n_participants * per_b, n_participants * per_b,
                     n_participants * per_e)


def round_comm_compressed_stacked(enc: Any, payload: Any,
                                  n_participants: int) -> RoundComm:
    """Compressed-uplink accounting from stacked trees: uplink priced on the
    ENCODED wire tree ``enc``, downlink on the raw ``payload``."""
    if payload is None:
        return RoundComm.zero()
    return RoundComm(n_participants * stacked_per_client_bytes(enc),
                     n_participants * stacked_per_client_bytes(payload),
                     n_participants * stacked_per_client_elems(enc))


def round_comm_payloads(payloads: Any) -> RoundComm:
    """Accounting from a list of per-participant payload trees (the loop
    server layout).  ``None`` entries (non-communicating strategies) are
    free."""
    if payloads is None:
        return RoundComm.zero()
    up_b = sum(tree_bytes(p) for p in payloads if p is not None)
    up_e = sum(tree_elems(p) for p in payloads if p is not None)
    return RoundComm(up_b, up_b, up_e)


def round_comm_compressed_payloads(encs: Any, payloads: Any) -> RoundComm:
    """Compressed-uplink accounting from per-participant trees: uplink
    bytes and elements of the ENCODED wire trees ``encs``, downlink bytes of
    the raw ``payloads``."""
    if payloads is None:
        return RoundComm.zero()
    return RoundComm(sum(tree_bytes(e) for e in encs if e is not None),
                     sum(tree_bytes(p) for p in payloads if p is not None),
                     sum(tree_elems(e) for e in encs if e is not None))
