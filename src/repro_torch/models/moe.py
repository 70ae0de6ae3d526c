"""Mixture-of-Experts MLP — GShard/Switch-style dense-dispatch formulation;
PyTorch port of ``repro.models.moe``.

Tokens are dispatched with one-hot dispatch/combine tensors and einsums, as
in the JAX package: each sequence (or each ``MOE_GROUP``-token group of a
long one) is a dispatch group whose experts hold ``capacity`` slots; a
token past its expert's capacity is dropped (its MLP output is zero), and
the Switch load-balance loss keeps the drop rate low.  The experts are
frozen in CE-LoRA fine-tuning (adapters attach to attention).  The JAX
package computes the experts as XLA einsums, outside any Pallas kernel, so
the port's counterpart is ``torch.einsum`` (batched matmuls).

Padded tokens (zeros appended to fill the last group) take part in routing
and in the aux mean, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

MOE_GROUP = 1024          # tokens per dispatch group (capacity granularity)
MOE_CHUNK_TOKENS = 16384  # max tokens in flight through the expert einsums


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """The router (d, E) in f32 and the experts (E, d, f) / (E, f, d) in
    ``cfg.dtype``, drawn from ``generator`` on its device."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    dt = cfg.dtype
    p = {"router": layers._normal(generator, (d, e), s_in, torch.float32)}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = layers._normal(generator, (e, d, f), s_in, dt)
        p["w_up"] = layers._normal(generator, (e, d, f), s_in, dt)
        p["w_down"] = layers._normal(generator, (e, f, d), s_out, dt)
    else:
        p["w_in"] = layers._normal(generator, (e, d, f), s_in, dt)
        p["w_out"] = layers._normal(generator, (e, f, d), s_out, dt)
    return p


def capacity(cfg: ModelConfig, seq: int) -> int:
    """Slots per expert in a group of ``seq`` tokens: a multiple of 8 with
    a floor of 8, and 1 for one token (decode)."""
    c = int(seq * max(cfg.top_k, 1) * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8) if seq > 1 else 1


def _route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """:func:`route` with the aux loss per group: (dispatch, combine,
    aux (B,) f32)."""
    e, k, c = cfg.n_experts, cfg.top_k, capacity(cfg, x.shape[1])
    logits = x.float() @ router_w                              # (B,S,E)
    probs = torch.softmax(logits, dim=-1)

    # top-k selection, one expert at a time (iteratively masked argmax;
    # torch.argmax takes the first maximal index, as jnp.argmax)
    gates = torch.zeros_like(probs)
    sel = torch.zeros_like(probs)
    masked = probs
    for _ in range(k):
        onehot = F.one_hot(torch.argmax(masked, dim=-1), e).float()
        gates = gates + onehot * probs
        sel = sel + onehot
        masked = masked * (1.0 - onehot)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each token inside its expert's buffer (per group)
    pos = torch.cumsum(sel, dim=1) * sel - 1.0                 # (B,S,E)
    keep = (pos >= 0) & (pos < c)
    slot = F.one_hot(pos.clamp(0, c - 1).long(), c).float()    # (B,S,E,C)
    dispatch = slot * keep[..., None]
    combine = dispatch * gates[..., None]

    # Switch load-balance auxiliary loss, one term per group
    frac_tokens = torch.mean(sel / max(k, 1), dim=1)           # (B,E)
    frac_probs = torch.mean(probs, dim=1)                      # (B,E)
    aux = e * torch.sum(frac_tokens * frac_probs, dim=-1)      # (B,)
    return dispatch, combine, aux


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x (B,S,D) → (dispatch (B,S,E,C), combine (B,S,E,C) f32, aux loss f32
    scalar): the f32 router's softmax, top-k by an iteratively masked
    argmax with the gates renormalised over the k picks, each token's slot
    its per-sequence ``cumsum`` position, drops past ``capacity``, and the
    Switch aux ``e · mean_b Σ_e frac_tokens · frac_probs``."""
    dispatch, combine, aux = _route(cfg, router_w, x)
    return dispatch, combine, aux.mean()


def _moe_grouped(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """One grouped call over the groups x (B,S,D): (out (B,S,D) in x.dtype,
    aux (B,) f32 per group)."""
    dispatch, combine, aux = _route(cfg, p["router"], x)
    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)  # (E,B,C,D)
    if cfg.mlp_type == "swiglu":
        g = torch.einsum("ebcd,edf->ebcf", xin, p["w_gate"])
        u = torch.einsum("ebcd,edf->ebcf", xin, p["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
        out_e = torch.einsum("ebcf,efd->ebcd", h, p["w_down"])
    else:
        h = torch.einsum("ebcd,edf->ebcf", xin, p["w_in"])
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        out_e = torch.einsum("ebcf,efd->ebcd", h, p["w_out"])
    out = torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), out_e)
    return out, aux


def moe_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            by_row: bool = False) -> tuple:
    """Returns (out (B,S,D), aux loss f32): the aux a scalar, the mean over
    every group as the JAX package computes it, or with ``by_row`` a (B,)
    vector, sequence i's mean over its own groups (what a batch of that
    sequence alone gives; the mean of the vector is the scalar).

    A sequence longer than ``MOE_GROUP`` tokens is padded to whole groups
    of ``MOE_GROUP``; when there are more than ``MOE_CHUNK_TOKENS`` tokens'
    worth of groups and their count is a multiple of a chunk's, the groups
    go through the experts a chunk at a time — each chunk under
    ``torch.utils.checkpoint`` while autograd records, as the JAX package
    maps a ``jax.checkpoint``-ed chunk — and the scalar aux is the mean of
    the chunks' means."""
    b, s, d = x.shape
    group = min(MOE_GROUP, s)
    pad = (-s) % group
    if pad == 0 and s <= group:
        out, aux = _moe_grouped(cfg, p, x)
        return out, (aux if by_row else aux.mean())
    xg = F.pad(x, (0, 0, 0, pad)) if pad else x
    per_seq = (s + pad) // group
    nb = b * per_seq
    xg = xg.reshape(nb, group, d)

    chunk = max(1, MOE_CHUNK_TOKENS // group)
    if nb > chunk and nb % chunk == 0:
        remat = torch.is_grad_enabled()
        parts = [checkpoint(_moe_grouped, cfg, p, xc, use_reentrant=False,
                            preserve_rng_state=False)
                 if remat else _moe_grouped(cfg, p, xc)
                 for xc in xg.split(chunk)]
        out = torch.cat([o for o, _ in parts])
        auxs = torch.stack([a for _, a in parts])              # (n, chunk)
        aux_all = auxs.reshape(nb)
        scalar = auxs.mean(1).mean()
    else:
        out, aux_all = _moe_grouped(cfg, p, xg)
        scalar = aux_all.mean()
    out = out.reshape(b, s + pad, d)[:, :s]
    if by_row:
        return out, aux_all.reshape(b, per_seq).mean(1)
    return out, scalar
