"""Optimal transport: entropic Sinkhorn + GMM Wasserstein (paper §III-C.1):
PyTorch port of ``repro.core.similarity.ot``.

1. ``mw2`` — the Delon–Desolneux distance between two GMMs: OT over
   mixture components with closed-form Gaussian W2² costs.
2. ``dataset_distance`` — OT over categories, with per-category-pair MW2
   costs GW; eqn (6) solves γ* with Sinkhorn and eqn (5) evaluates
   Σ γ*_cd · GW_cd.

Every function takes optional leading batch dimensions, so one call solves
all client pairs and all category pairs at once (the JAX package ``vmap``s
the same per-problem functions).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.similarity.gmm import GMM, gaussian_w2_sq


def sinkhorn(a: torch.Tensor, b: torch.Tensor, cost: torch.Tensor,
             eps: float = 0.05, n_iters: int = 200) -> torch.Tensor:
    """Entropic OT plan γ (…, n, m) with marginals a (…, n), b (…, m) for
    cost (…, n, m); log-domain iterations, the cost scaled by its largest
    magnitude per problem (scale-free eps)."""
    scale = cost.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    cost = cost / scale
    log_a = torch.log(a.clamp_min(1e-30))
    log_b = torch.log(b.clamp_min(1e-30))
    mk = -cost / eps
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_b)
    for _ in range(n_iters):
        f = eps * (log_a - torch.logsumexp(mk + g[..., None, :] / eps,
                                           dim=-1))
        g = eps * (log_b - torch.logsumexp(mk + f[..., :, None] / eps,
                                           dim=-2))
    return torch.exp(mk + f[..., :, None] / eps + g[..., None, :] / eps)


def mw2(gmm_a: GMM, gmm_b: GMM, eps: float = 0.05) -> torch.Tensor:
    """MW2² between GMMs with components on axis -2 of the means (weights
    (…, Ga), means/variances (…, Ga, D)); returns (…)."""
    cost = gaussian_w2_sq(gmm_a.means[..., :, None, :],
                          gmm_a.variances[..., :, None, :],
                          gmm_b.means[..., None, :, :],
                          gmm_b.variances[..., None, :, :])     # (…, Ga, Gb)
    plan = sinkhorn(gmm_a.weights, gmm_b.weights, cost, eps)
    return torch.sum(plan * cost, dim=(-2, -1))


def dataset_distance(gmms_a: GMM, counts_a: torch.Tensor, gmms_b: GMM,
                     counts_b: torch.Tensor,
                     eps: float = 0.05) -> torch.Tensor:
    """Paper eqns (5)–(6): category-level OT between two clients' GMM sets
    (weights (…, Ka, G), means (…, Ka, G, D); counts (…, Ka) define the
    category marginals).  Returns Σ γ*_cd GW_cd (…) — a DISTANCE."""
    ga = GMM(gmms_a.weights.unsqueeze(-2), gmms_a.means.unsqueeze(-3),
             gmms_a.variances.unsqueeze(-3))                 # (…, Ka, 1, …)
    gb = GMM(gmms_b.weights.unsqueeze(-3), gmms_b.means.unsqueeze(-4),
             gmms_b.variances.unsqueeze(-4))                 # (…, 1, Kb, …)
    gw = mw2(ga, gb, eps)                                     # (…, Ka, Kb)
    a = counts_a / counts_a.sum(-1, keepdim=True).clamp_min(1e-12)
    b = counts_b / counts_b.sum(-1, keepdim=True).clamp_min(1e-12)
    plan = sinkhorn(a, b, gw, eps)
    return torch.sum(plan * gw, dim=(-2, -1))


def distance_to_affinity(dist: torch.Tensor,
                         tau: Optional[float] = None) -> torch.Tensor:
    """Map a symmetric (m, m) distance matrix to an affinity (higher =
    more similar) with exp(-d/τ), τ = the median off-diagonal distance (the
    mean of the two middle values for an even count, as ``jnp.median``)."""
    m = dist.shape[0]
    off = dist[~torch.eye(m, dtype=torch.bool, device=dist.device)]
    tau_val = torch.quantile(off, 0.5) if tau is None else \
        torch.as_tensor(tau, dtype=dist.dtype, device=dist.device)
    return torch.exp(-dist / tau_val.clamp_min(1e-12))
