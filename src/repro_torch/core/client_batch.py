"""Batched-over-clients tree utilities (the vectorized federated runtime):
PyTorch port of the stacked-state half of ``repro.core.client_batch``.

The loop path keeps the m clients' states as a list of identically shaped
trees; the vectorized path keeps ONE tree whose every leaf carries a
leading client axis:

    list of m states, leaves (…)   ⇄   one state, leaves (m, …)

The strategies (:mod:`.baselines`) are tree algebra, so they run on a
stacked state unchanged; the model folds the clients' batches into one
batch whose sequences each apply their own client's adapter
(``models.model.forward_hidden``'s ``adapter_rows``).  The client axis is
always axis 0.  The chunked prefetch of the scan engine
(``stack_cohort_batches``, ``stack_chunk_batches``, ``ChunkPrefetcher``,
``drive_chunks``) comes with that engine.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


def stack_states(states: Sequence[Any]) -> Any:
    """m identically structured trees → one tree with leaves (m, …)."""
    return tree_map(lambda *xs: torch.stack(xs), states[0], *states[1:])


def n_clients(stacked: Any) -> int:
    """Extent of the leading client axis."""
    return int(tree_leaves(stacked)[0].shape[0])


def client_state(stacked: Any, i: int) -> Any:
    """Client i's slice of a stacked tree (views)."""
    return tree_map(lambda t: t[i], stacked)


def unstack_states(stacked: Any) -> list:
    """Inverse of :func:`stack_states` (m per-client trees, views)."""
    return [client_state(stacked, i) for i in range(n_clients(stacked))]


def _rows_mask(mask: Any, like: torch.Tensor) -> torch.Tensor:
    """A boolean (m,) mask on ``like``'s device, shaped to broadcast over
    its trailing axes."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=like.device)
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def select_clients(mask: Any, new: Any, old: Any) -> Any:
    """Per-client select over the leading axis: client i's leaves come from
    ``new`` where ``mask[i]``, else from ``old`` — the masked install of
    partial participation (unsampled clients keep their state).  ``mask``
    is boolean (m,)."""
    return tree_map(lambda n_, o_: torch.where(_rows_mask(mask, n_), n_, o_),
                    new, old)


def gather_clients(stacked: Any, ids: Any) -> Any:
    """Rows ``ids`` of a stacked tree: leaves (m, …) → (k, …)."""
    def take(t):
        return t[torch.as_tensor(ids, dtype=torch.long, device=t.device)]
    return tree_map(take, stacked)


def scatter_clients(stacked: Any, ids: Any, values: Any) -> Any:
    """Functional inverse of :func:`gather_clients`: a new tree with rows
    ``ids`` of ``stacked`` (leaves (m, …)) replaced by ``values`` (leaves
    (k, …)); ``ids`` must be unique."""
    def put(t, v):
        idx = torch.as_tensor(ids, dtype=torch.long, device=t.device)
        return t.index_copy(0, idx, v.to(t.dtype))
    return tree_map(put, stacked, values)


def broadcast_to_clients(tree: Any, m: int) -> Any:
    """Replicate one (global) tree over the client axis: leaves (…) →
    (m, …) — used to install a FedAvg downlink into a stacked state."""
    return tree_map(lambda t: t[None].expand((m,) + tuple(t.shape))
                    .contiguous(), tree)


def stack_client_batches(loaders: Sequence, n_batches: int, *,
                         device) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``n_batches`` minibatches from each client's loader and collate
    them into ``(m, n_batches, B, T)`` tokens and ``(m, n_batches, B)``
    labels on ``device``.  The draws come from the same per-client streams
    as the loop path's, so both paths see the same data."""
    toks, labs = [], []
    for ld in loaders:
        bt = list(ld.batches(n_batches))
        toks.append(np.stack([b["tokens"] for b in bt]))
        labs.append(np.stack([b["labels"] for b in bt]))
    return (torch.as_tensor(np.stack(toks), device=device),
            torch.as_tensor(np.stack(labs), device=device))
