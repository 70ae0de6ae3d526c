"""Model similarity via linear Centered Kernel Alignment (paper §III-C.2):
PyTorch port of ``repro.core.similarity.cka``.

Per paper eqns (7)–(9): a shared random probe batch Z (n × r) is pushed
through each client's transmitted core matrix C_i; the linear kernels
K_i = (Z C_i)(Z C_i)ᵀ are compared with the HSIC ratio

    CKA(C_i, C_j) = HSIC(K_i, K_j) / sqrt(HSIC(K_i,K_i)·HSIC(K_j,K_j)).

The probe batch is an input (the JAX package draws it from
``jax.random.normal(key, (n_probes, r))``; :func:`draw_probes` draws it
from a ``torch.Generator``).  All pairs and all adapted modules are
computed with batched products, no per-pair loop.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.compress import _sorted_tree
from repro_torch.tree import tree_leaves


def draw_probes(generator: torch.Generator, n_probes: int,
                r: int) -> torch.Tensor:
    """A standard-normal (n_probes, r) f32 probe batch."""
    return torch.randn((n_probes, r), generator=generator,
                       device=generator.device, dtype=torch.float32)


def _center(k: torch.Tensor) -> torch.Tensor:
    """Double mean-centering H K H over the last two axes."""
    return (k - k.mean(dim=-2, keepdim=True) - k.mean(dim=-1, keepdim=True)
            + k.mean(dim=(-2, -1), keepdim=True))


def _centered_kernels(c: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """H (Z C)(Z C)ᵀ H for C (…, r, r) → (…, n, n)."""
    y = probes.float() @ c.float()
    return _center(y @ y.transpose(-2, -1))


def _pair_cka(rows: torch.Tensor, cols: torch.Tensor,
              probes: torch.Tensor) -> torch.Tensor:
    """rows (a, M, r, r), cols (b, M, r, r) → (a, b, M) per-module CKA,
    with HSIC = tr(K H L H) (eqn 9) summed without forming the product."""
    kr = _centered_kernels(rows, probes)                 # (a, M, n, n)
    kc = _centered_kernels(cols, probes)                 # (b, M, n, n)
    h_rc = torch.einsum("amxy,bmyx->abm", kr, kc)
    h_rr = torch.einsum("amxy,amyx->am", kr, kr)
    h_cc = torch.einsum("bmxy,bmyx->bm", kc, kc)
    return h_rc / torch.sqrt(h_rr[:, None] * h_cc[None]).clamp_min(1e-12)


def pairwise_cka(c_stack: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """c_stack: (m, r, r), one C per client → the (m, m) CKA matrix."""
    return _pair_cka(c_stack[:, None], c_stack[:, None], probes)[..., 0]


def stack_client_cs(c_trees: list) -> torch.Tensor:
    """Flatten each client's C tree to (n_modules, r, r) — leading
    layer-stack axes fold into the module axis, modules in the JAX
    package's order (dict keys sorted) — and stack the clients: (m,
    n_modules, r, r)."""
    def flat(t):
        return torch.cat([leaf.reshape(-1, leaf.shape[-2], leaf.shape[-1])
                          for leaf in tree_leaves(_sorted_tree(t))], dim=0)
    return torch.stack([flat(t) for t in c_trees])


def stacked_cs(c_tree: Any) -> torch.Tensor:
    """Stacked-payload form of :func:`stack_client_cs`: ONE C tree whose
    leaves carry a leading client axis (m, …, r, r), folded to (m,
    n_modules, r, r) in the same module order, whatever the order of the
    tree's dicts (a decoded payload's, a state's)."""
    return torch.cat([leaf.reshape(leaf.shape[0], -1, leaf.shape[-2],
                                   leaf.shape[-1])
                      for leaf in tree_leaves(_sorted_tree(c_tree))], dim=1)


def pairwise_model_similarity(c_trees: list,
                              probes: torch.Tensor) -> torch.Tensor:
    """S^model (m, m): mean over adapted modules of per-module CKA."""
    cs = stack_client_cs(c_trees)
    return _pair_cka(cs, cs, probes).mean(-1)


def pairwise_model_similarity_stacked(c_tree: Any,
                                      probes: torch.Tensor) -> torch.Tensor:
    """S^model (m, m) from a stacked C payload (leaves (m, …, r, r))."""
    cs = stacked_cs(c_tree)
    return _pair_cka(cs, cs, probes).mean(-1)


def refresh_rows_inline(prev: torch.Tensor, cs: torch.Tensor, ids,
                        probes: torch.Tensor) -> torch.Tensor:
    """Recompute rows and columns ``ids`` of the cached CKA matrix ``prev``
    against the current (m, n_modules, r, r) stack ``cs`` — always the row
    computation, even when ``ids`` covers every client (the robust round's
    masked S^model refresh reads it as the JAX package's row refresh)."""
    ids = torch.as_tensor(ids, dtype=torch.long, device=cs.device)
    rows = _pair_cka(cs[ids], cs, probes).mean(-1)          # (k, m)
    s = prev.to(rows.dtype).clone()
    s[ids, :] = rows
    s[:, ids] = rows.T
    return s


def refresh_pairwise_cka(prev: Optional[torch.Tensor], cs: torch.Tensor,
                         changed_ids, probes: torch.Tensor) -> torch.Tensor:
    """Partial-participation S^model update: recompute only the rows and
    columns of the ``changed_ids`` clients (whose Cs moved since the last
    refresh) against the current (m, n_modules, r, r) stack ``cs``; every
    other pair keeps its cached entry, which is still exact because both
    Cs are frozen.  With no cache yet, or every client changed, this is the
    full computation."""
    ids = torch.as_tensor(changed_ids, dtype=torch.long, device=cs.device)
    if prev is None or int(ids.numel()) == int(cs.shape[0]):
        return _pair_cka(cs, cs, probes).mean(-1)
    return refresh_rows_inline(prev, cs, ids, probes)
