"""Server-side model parameter aggregation (paper §III-C): PyTorch port of
``repro.core.aggregation``.

``personalized_weights`` implements eqn (3): per-client aggregation weights
from the combined affinity S = S^data + S^model, self excluded, with the
beyond-paper ``self_weight`` λ (default 0 = faithful):
C̄_i = λ·C_i + (1-λ)·Σ_{j≠i} w_ij C_j.

``aggregate_payloads`` applies eqn (3) weights to a list of per-client
payload trees (out_i = Σ_j W[i,j]·p_j); ``fedavg`` is the FedPETuning
baseline (sample-count weighted mean, one global result).  Both stack the
list on a leading client axis and reduce with the stacked forms
(``aggregate_stacked``, ``fedavg_stacked``: one contraction over the
client axis per leaf), which the vectorized runtime calls directly, as the
JAX package does.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.tree import tree_leaves, tree_map


def personalized_weights(similarity: torch.Tensor, self_weight: float = 0.0,
                         participants: Optional[torch.Tensor] = None,
                         col_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """similarity: (m, m), symmetric, higher = more similar.  Returns the
    row-stochastic W (m, m): W[i] are client i's aggregation weights.

    ``participants`` (optional boolean (m,) mask): only participating
    clients' columns carry weight and each row renormalizes over them.
    ``col_scale`` (optional (m,) float, the async engine's staleness
    discount ``decay**staleness``) multiplies the columns before the row
    normalization; ``None`` leaves eqn (3) bit for bit as it was.  A row
    whose eligible similarities are all ≤ 0 falls back to UNIFORM over the
    eligible others; a row with no eligible other keeps itself."""
    m = similarity.shape[0]
    dev = similarity.device
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    s = torch.where(eye, torch.zeros((), dtype=similarity.dtype, device=dev),
                    similarity)
    s = s.clamp_min(0.0)
    eligible = ~eye
    if participants is not None:
        pmask = torch.as_tensor(participants, dtype=torch.bool, device=dev)
        s = torch.where(pmask[None, :], s, torch.zeros_like(s))
        eligible = eligible & pmask[None, :]
    if col_scale is not None:
        s = s * torch.as_tensor(col_scale, dtype=s.dtype, device=dev)[None, :]
    denom = s.sum(dim=1, keepdim=True)
    n_elig = eligible.sum(dim=1, keepdim=True)
    uniform = eligible.to(s.dtype) / n_elig.clamp_min(1).to(s.dtype)
    ok = denom > 1e-12
    w = torch.where(ok, s / torch.where(ok, denom, torch.ones_like(denom)),
                    uniform)
    w = torch.where(n_elig > 0, w, torch.eye(m, dtype=w.dtype, device=dev))
    if self_weight:
        w = (1.0 - self_weight) * w + self_weight * torch.eye(
            m, dtype=w.dtype, device=dev)
    return w


def _stack(payloads: Sequence[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), payloads[0], *payloads[1:])


def aggregate_stacked(stacked: Any, weights: torch.Tensor) -> Any:
    """Eqn (3) mixing over a STACKED payload: leaves (m, …) → (m, …) with
    out[i] = Σ_j W[i,j]·leaf[j], one contraction per leaf."""
    return tree_map(lambda leaf: torch.einsum(
        "ij,j...->i...", weights.to(leaf.dtype), leaf), stacked)


def aggregate_payloads(payloads: Sequence[Any],
                       weights: torch.Tensor) -> list:
    """Eqn (3) mixing: list of m payload trees in, list of m per-client
    aggregates out (out_i = Σ_j W[i,j]·p_j)."""
    mixed = aggregate_stacked(_stack(payloads), weights)
    return [tree_map(lambda leaf, i=i: leaf[i], mixed)
            for i in range(weights.shape[0])]


def fedavg(payloads: Sequence[Any], sample_counts: Sequence[int],
           participants: Optional[torch.Tensor] = None) -> Any:
    """FedPETuning-style sample-weighted average; returns ONE global tree
    (:func:`fedavg_stacked` of the stacked list)."""
    return fedavg_stacked(_stack(payloads), sample_counts, participants)


def fedavg_stacked(stacked: Any, sample_counts: Sequence[int],
                   participants: Optional[torch.Tensor] = None,
                   col_scale: Optional[torch.Tensor] = None) -> Any:
    """FedAvg over a STACKED payload: leaves (m, …) → ONE global tree, the
    sample-count weighted mean over the client axis.  ``participants``
    zeroes absent clients' counts so the mean renormalizes over the
    participants (absent terms add exact zeros); with every eligible count
    zero the mean is uniform over the eligible clients.  ``col_scale``
    (optional (m,) float, the async engine's staleness discount) multiplies
    each contributor's count before the normalization; ``None`` leaves the
    mean bit for bit as it was."""
    dev = tree_leaves(stacked)[0].device
    n = torch.as_tensor(sample_counts, dtype=torch.float32, device=dev)
    elig = (torch.ones_like(n) if participants is None else
            torch.as_tensor(participants, device=dev).to(torch.float32))
    n = n * elig
    if col_scale is not None:
        n = n * torch.as_tensor(col_scale, dtype=n.dtype, device=dev)
    tot = n.sum()
    uniform = elig / elig.sum().clamp_min(1.0)
    w = torch.where(tot > 0, n / torch.where(tot > 0, tot,
                                             torch.ones_like(tot)), uniform)
    return tree_map(lambda leaf: torch.einsum("j,j...->...",
                                              w.to(leaf.dtype), leaf),
                    stacked)


def combined_similarity(s_data: torch.Tensor, s_model: torch.Tensor,
                        data_weight: float = 1.0,
                        model_weight: float = 1.0) -> torch.Tensor:
    """Paper eqn (4): S = S^data + S^model (weights are a beyond-paper
    knob, both 1.0 = faithful)."""
    return data_weight * s_data + model_weight * s_model
