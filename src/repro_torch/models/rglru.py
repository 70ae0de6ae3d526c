"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427);
PyTorch port of ``repro.models.rglru``.

Block: x → [main, gate] linears → main: temporal conv1d (w=4) → RG-LRU →
⊙ GeLU(gate) → output linear.

RG-LRU recurrence (per channel):
    r_t = σ(x_t·W_a + b_a)            recurrence gate
    i_t = σ(x_t·W_x + b_x)            input gate
    a_t = exp(-c·softplus(Λ)·r_t)     data-dependent decay, c = 8
    h_t = a_t·h_{t-1} + sqrt(1 - a_t²)·(i_t·x_t)

The sequence runs in chunks of 512 steps with h carried across them; inside
a chunk a log-depth (Hillis–Steele) scan over the combine
``(a_l·a_r, b_l·a_r + b_r)`` — the operator of the JAX package's
``lax.associative_scan`` — computes every h_t, and while autograd records
each chunk runs under ``torch.utils.checkpoint``.  The JAX package has no
Pallas kernel for the recurrence (XLA ops), so neither has the port.  The
tri-LoRA adapters attach to the two linears ``w_in`` / ``w_out`` (through
``layers.dense``: the tri-LoRA kernels on the card, their grouped forms
with ``adapter_rows``).  Decode carries (conv tail, h).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

_C = 8.0
SCAN_CHUNK = 512


def init_rglru_block(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d, rd, cw = cfg.d_model, cfg.rnn_d, cfg.conv1d_width
    dt, dev = cfg.dtype, generator.device
    # Λ = softplus⁻¹(-log u / c) for u ~ U(0.9, 0.999), so that a = u at
    # r = 1 (Griffin appendix)
    u = torch.rand((rd,), generator=generator, device=dev,
                   dtype=torch.float32) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _C))

    def zeros():
        return torch.zeros((rd,), dtype=dt, device=dev)

    return {
        "w_in": layers._normal(generator, (d, 2 * rd), 1.0 / math.sqrt(d),
                               dt),
        "conv_w": layers._normal(generator, (cw, rd), 1.0 / math.sqrt(cw),
                                 dt),
        "conv_b": zeros(),
        "lam": lam,
        "w_a": layers._normal(generator, (rd, rd), 1.0 / math.sqrt(rd), dt),
        "b_a": zeros(),
        "w_x": layers._normal(generator, (rd, rd), 1.0 / math.sqrt(rd), dt),
        "b_x": zeros(),
        "w_out": layers._normal(generator, (rd, d), 1.0 / math.sqrt(rd),
                                dt),
    }


def _gates(p: dict, x: torch.Tensor):
    """x (…, rd) → decay a (f32), gated input b (f32)."""
    r = torch.sigmoid((x @ p["w_a"] + p["b_a"]).float())
    i = torch.sigmoid((x @ p["w_x"] + p["b_x"]).float())
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * i * x.float()
    return a, gated


def _conv1d(p: dict, x: torch.Tensor, tail: Optional[torch.Tensor]):
    """Causal depthwise temporal conv, width cw.  tail: (B, cw-1, rd)."""
    cw = p["conv_w"].shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], cw - 1, x.shape[-1]))
    xp = torch.cat([tail, x], dim=1)                          # (B, T+cw-1, rd)
    t = x.shape[1]
    out = sum(xp[:, i:i + t] * p["conv_w"][i] for i in range(cw))
    return out + p["conv_b"], xp[:, -(cw - 1):]


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t over axis 1 from h = 0:
    log2(L) Hillis–Steele levels, each combining element t with element
    t - step as ``(a_l·a_r, b_l·a_r + b_r)``."""
    n, step = a.shape[1], 1
    while step < n:
        a_r, b_r = a[:, step:], b[:, step:]
        b = torch.cat([b[:, :step], b[:, :-step] * a_r + b_r], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a_r], dim=1)
        step *= 2
    return b


def _chunk_step(h: torch.Tensor, ac: torch.Tensor, bc: torch.Tensor):
    """One chunk: the carried h enters through the first step's input."""
    bc = torch.cat([bc[:, :1] + ac[:, :1] * h[:, None], bc[:, 1:]], dim=1)
    return _scan(ac, bc)


def _chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                         chunk: int = SCAN_CHUNK) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t over axis 1 from h0, computed chunk by chunk
    (padding with a = 1, b = 0), h carried across chunks; each chunk under
    ``torch.utils.checkpoint`` while autograd records, which bounds the
    backward's residuals to one chunk."""
    bsz, t, _ = a.shape
    chunk = min(chunk, t)
    pad = (-t) % chunk
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    remat = torch.is_grad_enabled()
    h, hs = h0, []
    for ac, bc in zip(a.split(chunk, 1), b.split(chunk, 1)):
        hc = (checkpoint(_chunk_step, h, ac, bc, use_reentrant=False,
                         preserve_rng_state=False)
              if remat else _chunk_step(h, ac, bc))
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, dim=1)[:, :t]


def rglru_block(cfg: ModelConfig, p: dict, x: torch.Tensor, state,
                adapters=None, *,
                adapter_rows: Optional[torch.Tensor] = None):
    """x (B,T,D); state {'conv': (B,cw-1,rd), 'h': (B,rd) f32} or None.
    Returns (out (B,T,D), the new state).  ``adapter_rows`` (B,) switches
    the w_in / w_out adapters to stacked (m, …) factors, sequence i
    applying adapter ``adapter_rows[i]``."""
    ad = adapters or {}
    kw = dict(lora_scaling=cfg.lora_alpha / cfg.lora_rank,
              adapter_rows=adapter_rows)
    conv_tail = state["conv"] if state else None
    h0 = state["h"] if state else torch.zeros(
        (x.shape[0], cfg.rnn_d), dtype=torch.float32, device=x.device)

    z = layers.dense(x, p["w_in"], adapter=ad.get("w_in"), **kw)
    main, gate = torch.chunk(z, 2, dim=-1)
    main, new_tail = _conv1d(p, main, conv_tail)
    a, b = _gates(p, main)                                     # (B,T,rd) f32

    h = _chunked_linear_scan(a, b, h0)

    y = h.to(x.dtype) * F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    out = layers.dense(y, p["w_out"], adapter=ad.get("w_out"), **kw)
    return out, {"conv": new_tail, "h": h[:, -1]}


def init_state(cfg: ModelConfig, batch: int, *, device) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, cfg.rnn_d),
                            dtype=cfg.dtype, device=device),
        "h": torch.zeros((batch, cfg.rnn_d), dtype=torch.float32,
                         device=device),
    }
