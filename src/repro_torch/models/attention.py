"""Attention: GQA params, q/k/v projection, the reference SDPA, and
one-token decode against a ring-buffered KV cache.

PyTorch port of the decode half of ``repro.models.attention``.  Decode
attention runs through :func:`repro_torch.kernels.decode_attention.ops.
decode_attention`: the hand-written kernel on CUDA, its plain version on
the CPU.  Prefill, flash and blockwise attention come with the training
slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attn(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.hd
    h, k = cfg.n_heads, cfg.n_kv_heads
    s = 1.0 / math.sqrt(d)
    dev, dt = generator.device, cfg.dtype
    p = {"wq": layers._normal(generator, (d, h * hd), s, dt),
         "wk": layers._normal(generator, (d, k * hd), s, dt),
         "wv": layers._normal(generator, (d, k * hd), s, dt),
         "wo": layers._normal(generator, (h * hd, d), 1.0 / math.sqrt(h * hd),
                              dt)}
    if cfg.attn_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((k * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((k * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.zeros((hd,), dtype=dt, device=dev)}
        p["k_norm"] = {"scale": torch.zeros((hd,), dtype=dt, device=dev)}
    return p


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, adapters, *,
                 adapter_rows: Optional[torch.Tensor] = None):
    """Return q (B,S,H,hd), k,v (B,S,K,hd) — rope NOT yet applied."""
    ad = adapters or {}
    sc = cfg.lora_alpha / cfg.lora_rank
    b, s, _ = x.shape
    kw = dict(lora_scaling=sc, adapter_rows=adapter_rows)
    q = layers.dense(x, p["wq"], bias=p.get("bq"), adapter=ad.get("wq"),
                     **kw).reshape(b, s, cfg.n_heads, cfg.hd)
    k = layers.dense(x, p["wk"], bias=p.get("bk"), adapter=ad.get("wk"),
                     **kw).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = layers.dense(x, p["wv"], bias=p.get("bv"), adapter=ad.get("wv"),
                     **kw).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(q, p["q_norm"]["scale"])
        k = layers.rmsnorm(k, p["k_norm"]["scale"])
    return q, k, v


def _rope(cfg: ModelConfig, x: torch.Tensor, positions) -> torch.Tensor:
    if cfg.pos_type == "rope":
        return layers.apply_rope(x, positions, cfg.rope_theta)
    if cfg.pos_type == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet")
    return x  # learned / none: positions handled at the embedding


# ---------------------------------------------------------------------------
# reference SDPA (grouped-query, causal, optional window)
# ---------------------------------------------------------------------------

def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, window: int = 0,
         kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,K,hd); H % K == 0.  f32 softmax."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        # rows are the LAST sq queries of the skv-long sequence
        qpos = torch.arange(sq, device=q.device) + (skv - sq)
        kpos = torch.arange(skv, device=q.device)
        mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
    if kv_valid is not None:  # (B, Skv) extra validity (ring caches, padding)
        mask = (mask[None] & kv_valid[:, None, :])[:, None, None]
    else:
        mask = mask[None, None, None]
    logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                  device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# decode (one token, ring-buffered KV cache)
# ---------------------------------------------------------------------------

def decode_self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                          cache: dict, positions, adapters=None, *,
                          adapter_rows: Optional[torch.Tensor] = None):
    """x: (B, 1, D).  cache: {'k','v': (B, W, K, hd), 'idx': int32 scalar
    — or (B,) for RAGGED per-row positions: each sequence advances
    independently, and rows at idx -1 are masked batch slots that write
    nothing and attend to nothing}.

    The K/V ring buffers are updated IN PLACE (a functional copy would
    copy the whole cache every step); the returned cache holds the same
    K/V tensors and the advanced ``idx``.  A masked row's output is zero
    (the kernel contract; the JAX reference averages V there instead —
    serving discards masked rows either way).

    ``adapter_rows`` switches the q/k/v/o adapters to grouped/bank mode —
    ``adapters`` then carries stacked (m, …) factors per target.
    """
    q, k_new, v_new = _project_qkv(cfg, p, x, adapters,
                                   adapter_rows=adapter_rows)
    q = _rope(cfg, q, positions)
    k_new = _rope(cfg, k_new, positions)

    b = x.shape[0]
    k, v = cache["k"], cache["v"]
    ring = k.shape[1]
    idx = cache["idx"]                      # absolute position of the new token
    if idx.dim() == 0:
        slot = torch.remainder(idx, ring).reshape(1).long()
        k.index_copy_(1, slot, k_new.to(k.dtype))
        v.index_copy_(1, slot, v_new.to(v.dtype))
        new_idx = idx + 1
    else:                                   # ragged per-row ring positions
        decode_ref.ragged_cache_write(k, k_new[:, 0], idx)
        decode_ref.ragged_cache_write(v, v_new[:, 0], idx)
        new_idx = torch.where(idx >= 0, idx + 1, idx)
    out = decode_ops.decode_attention(q.contiguous(), k, v, idx)
    sc = cfg.lora_alpha / cfg.lora_rank
    ad = adapters or {}
    y = layers.dense(out.reshape(b, 1, -1), p["wo"], adapter=ad.get("wo"),
                     lora_scaling=sc, adapter_rows=adapter_rows)
    return y, {"k": k, "v": v, "idx": new_idx}


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                  device, window: int = 0, dtype=None) -> dict:
    ring = min(window, seq_len) if window else seq_len
    kh, hd = cfg.n_kv_heads, cfg.hd
    dt = dtype or cfg.dtype
    return {"k": torch.zeros((batch, ring, kh, hd), dtype=dt, device=device),
            "v": torch.zeros((batch, ring, kh, hd), dtype=dt, device=device),
            "idx": torch.zeros((), dtype=torch.int32, device=device)}
