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
forms come with the vectorized paths.
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
