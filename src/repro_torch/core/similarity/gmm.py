"""Per-category Gaussian Mixture Models fitted with EM (paper §III-C.1):
PyTorch port of ``repro.core.similarity.gmm``.

Each client fits, for every label category in its local data, a
G-component diagonal-covariance GMM over frozen-backbone features; only the
GMM parameters leave the client.  ``fit_gmm`` is deterministic given its
initial mean indices, which the caller draws (the JAX package draws them
with ``jax.random.choice``; the port takes them as an input, see
:func:`draw_init_idx`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GMM(NamedTuple):
    weights: torch.Tensor    # (G,)
    means: torch.Tensor      # (G, D)
    variances: torch.Tensor  # (G, D)


def _e_step(x: torch.Tensor, gmm: GMM):
    """Responsibilities (N, G)."""
    diff = x[:, None, :] - gmm.means[None]                     # (N,G,D)
    inv = 1.0 / gmm.variances                                  # (G,D)
    quad = torch.sum(diff * diff * inv[None], dim=-1)          # (N,G)
    logdet = torch.sum(torch.log(gmm.variances), dim=-1)       # (G,)
    d = x.shape[-1]
    logp = -0.5 * (quad + logdet + d * math.log(2 * math.pi))  # (N,G)
    logw = torch.log(gmm.weights.clamp_min(1e-12))
    joint = logp + logw
    norm = torch.logsumexp(joint, dim=-1, keepdim=True)
    return torch.exp(joint - norm)


def _m_step(x: torch.Tensor, resp: torch.Tensor, var_floor: float) -> GMM:
    nk = resp.sum(dim=0) + 1e-8                                # (G,)
    weights = nk / x.shape[0]
    means = (resp.T @ x) / nk[:, None]
    sq = (resp.T @ (x * x)) / nk[:, None]
    variances = torch.clamp_min(sq - means * means, var_floor)
    return GMM(weights, means, variances)


def draw_init_idx(generator: torch.Generator, n: int,
                  n_components: int) -> torch.Tensor:
    """``n_components`` distinct row indices of an (n, D) feature matrix."""
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:n_components]


def fit_gmm(init_idx: torch.Tensor, x: torch.Tensor, n_components: int,
            n_iters: int = 25, var_floor: float = 1e-4) -> GMM:
    """x: (N, D) features.  Means start at the rows ``init_idx`` (G
    distinct indices), weights at 1/G, variances at the global variance.
    Returns the fitted diagonal GMM in f32."""
    x = x.float()
    n, d = x.shape
    idx = torch.as_tensor(init_idx, device=x.device).long()
    if idx.shape != (n_components,):
        raise ValueError(f"init_idx shape {tuple(idx.shape)} != "
                         f"({n_components},)")
    var0 = torch.clamp_min(x.var(dim=0, unbiased=False), var_floor)
    gmm = GMM(torch.full((n_components,), 1.0 / n_components,
                         device=x.device),
              x[idx], var0.expand(n_components, d).clone())
    for _ in range(n_iters):
        resp = _e_step(x, gmm)
        gmm = _m_step(x, resp, var_floor)
    return gmm


def gaussian_w2_sq(mu_a, var_a, mu_b, var_b) -> torch.Tensor:
    """Closed-form squared 2-Wasserstein between diagonal Gaussians:
    |μa-μb|² + Σ_d (√va - √vb)²  (Bures metric, commuting covariances)."""
    dm = mu_a - mu_b
    ds = torch.sqrt(var_a) - torch.sqrt(var_b)
    return torch.sum(dm * dm, -1) + torch.sum(ds * ds, -1)
