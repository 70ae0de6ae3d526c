"""Shared neural-net layers: norms, rotary embeddings, MLPs, adapted dense.

PyTorch port of ``repro.models.layers``.  Params are plain nested dicts of
tensors with the JAX package's key paths; matmuls run in the param dtype,
norms / rope angles / activations in f32.  The JAX package's sharding
hints have no counterpart here: the port runs on one device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import tri_lora
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.tri_lora import ops as tri_lora_ops


# ---------------------------------------------------------------------------
# dense projection with optional tri-LoRA adapter
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor, *,
          bias: Optional[torch.Tensor] = None, adapter=None,
          lora_scaling: float = 1.0,
          adapter_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``adapter_rows`` switches the adapter to grouped/bank mode:
    ``adapter`` then holds STACKED (m, …) factors and each batch row ``i``
    applies bank row ``adapter_rows[i]`` (-1 = no delta).

    On CUDA the grouped mode with one token per sequence and no gradient
    (serving) runs the grouped GEMV kernel, which computes x·W and the
    delta in one f32 accumulation and writes an exactly-zero row for a
    masked slot (the plain path keeps x·W there and drops only the delta;
    serving discards masked rows either way).  Every other grouped call
    (vectorized clients in training: many tokens per sequence, or a
    gradient) runs the grouped tri-LoRA kernels, forward and dx, where a
    masked row keeps x·W as in the plain path.

    On CUDA a single adapter runs the tri-LoRA kernels (the forward, and
    dx / dW in the backward where x / W need a gradient), then the bias.
    In f32 the two paths take the same sums in another order.  In bf16 the
    kernel rounds P = s·(x·A)·C to x's dtype and adds P·B inside its f32
    accumulation, as the JAX package's kernel op does, where the plain path
    (like the JAX ``dense``) rounds the delta on its own and adds it to the
    rounded x·W: the two agree within bf16 tolerance."""
    if adapter is not None and adapter_rows is None and x.is_cuda:
        y = tri_lora_ops.tri_lora_matmul(x, w, adapter["A"], adapter["C"],
                                         adapter["B"], lora_scaling)
        return y if bias is None else y + bias
    if adapter is not None and adapter_rows is not None and x.is_cuda:
        lead = x.shape[:-1]
        grad = torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in (w, *adapter.values())))
        if math.prod(lead[1:]) == 1 and not grad:
            y = decode_ops.grouped_dense(
                adapter_rows.to(torch.int32),
                x.reshape(-1, x.shape[-1]).contiguous(), w, adapter["A"],
                adapter["C"], adapter["B"], scaling=lora_scaling)
            y = y.reshape(*lead, w.shape[-1])
        else:
            y = tri_lora_ops.grouped_tri_lora_matmul(
                x, w, adapter["A"], adapter["C"], adapter["B"], adapter_rows,
                lora_scaling)
        return y if bias is None else y + bias
    y = x @ w
    if bias is not None:
        y = y + bias
    if adapter is not None:
        if adapter_rows is not None:
            delta = tri_lora.apply_tri_lora_grouped(x, adapter, lora_scaling,
                                                    adapter_rows)
        else:
            delta = tri_lora.apply_tri_lora(x, adapter, lora_scaling)
        y = y + delta.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def norm(x: torch.Tensor, params: dict, norm_type: str) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


def group_rmsnorm(x: torch.Tensor, scale: torch.Tensor, n_groups: int,
                  eps: float = 64e-5) -> torch.Tensor:
    """Per-head GroupNorm used by RWKV's time-mix output (``ln_x``): mean
    and variance per group in f32, the result in x's dtype."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, n_groups, d // n_groups)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf.reshape(*lead, d) * scale.float()).to(x.dtype)


def init_norm(d: int, norm_type: str, dtype, device) -> dict:
    if norm_type == "rmsnorm":   # (1 + scale) convention
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# rotary position embeddings (RoPE and Qwen2-VL's M-RoPE), half-split
# ---------------------------------------------------------------------------

def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rope_angles(positions: torch.Tensor, head_dim: int,
                 theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim//2), f32."""
    return positions.float()[..., None] * _inv_freq(head_dim, theta,
                                                    positions.device)


def _mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                  sections) -> torch.Tensor:
    """M-RoPE: positions (..., S, 3) = (t, h, w) ids; ``sections`` splits the
    head_dim//2 frequency slots among the three components in that order
    (arXiv:2409.12191).  Slot j takes the angle of component ``comp[j]``'s
    position; angles (..., S, head_dim//2), f32."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    dev = positions.device
    # comp[j] = the number of section ends at or below slot j, built on the
    # device (no host-to-device copy: the decode step runs as a CUDA graph)
    slots = torch.arange(half, device=dev)
    comp = torch.zeros(half, dtype=torch.int64, device=dev)    # (half,)
    end = 0
    for n in sections[:-1]:
        end += n
        comp = comp + (slots >= end)
    pos = torch.gather(positions.float(), -1,
                       comp.expand(*positions.shape[:-1], half))
    return pos * _inv_freq(head_dim, theta, dev)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               *, sections=None) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S), or (B, S, 3) for M-RoPE with
    ``sections``."""
    hd = x.shape[-1]
    if sections is not None:
        ang = _mrope_angles(positions, hd, theta, sections)    # (B,S,half)
    else:
        ang = _rope_angles(positions, hd, theta)               # (B,S,half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _normal(generator: torch.Generator, shape, std: float, dtype):
    return (torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * std).to(dtype)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             mlp_type: str, dtype) -> dict:
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    if mlp_type == "swiglu":
        return {"w_gate": _normal(generator, (d_model, d_ff), s_in, dtype),
                "w_up": _normal(generator, (d_model, d_ff), s_in, dtype),
                "w_down": _normal(generator, (d_ff, d_model), s_out, dtype)}
    return {"w_in": _normal(generator, (d_model, d_ff), s_in, dtype),
            "w_out": _normal(generator, (d_ff, d_model), s_out, dtype)}


def mlp(x: torch.Tensor, params: dict, mlp_type: str, *, adapters=None,
        lora_scaling: float = 1.0,
        adapter_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    ad = adapters or {}
    kw = dict(lora_scaling=lora_scaling, adapter_rows=adapter_rows)
    if mlp_type == "swiglu":
        g = dense(x, params["w_gate"], adapter=ad.get("w_gate"), **kw)
        u = dense(x, params["w_up"], adapter=ad.get("w_up"), **kw)
        h = F.silu(g.float()).to(x.dtype) * u
        return dense(h, params["w_down"], adapter=ad.get("w_down"), **kw)
    h = dense(x, params["w_in"], adapter=ad.get("w_in"), **kw)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(h, params["w_out"], adapter=ad.get("w_out"), **kw)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   dtype) -> torch.Tensor:
    return _normal(generator, (vocab, d_model), 0.02, dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor,
            true_vocab: int = 0) -> torch.Tensor:
    """Tied LM head; logits in f32.  If the table is padded beyond
    ``true_vocab``, pad logits are set to -1e30 (softmax-exact)."""
    x2, t = x.reshape(-1, x.shape[-1]), table.to(x.dtype).T
    grad = torch.is_grad_enabled() and (x2.requires_grad or t.requires_grad)
    if x.is_cuda and x.dtype != torch.float32 and not grad:
        # operands in the param dtype, f32 accumulation AND f32 output (a
        # bf16 product would round the logits before the argmax).  This
        # form of mm has no derivative: with a gradient the operands go to
        # f32 below (their products are exact there, only the order of the
        # sum differs)
        logits = torch.mm(x2, t, out_dtype=torch.float32)
    else:
        logits = x2.float() @ t.float()
    logits = logits.reshape(*x.shape[:-1], table.shape[0])
    if true_vocab and table.shape[0] > true_vocab:
        logits[..., true_vocab:] = -1e30
    return logits
