"""Attention: GQA params, q/k/v projection, full-sequence self- and
cross-attention with a backend registry, and one-token decode against a
ring-buffered KV cache.

PyTorch port of ``repro.models.attention``.  Every self-attention call
resolves its backend through :func:`select_impl` (explicit ``impl=`` >
``cfg.attn_impl`` > "auto"), as in the JAX package: ``"ref"`` is
:func:`sdpa`, ``"blockwise"`` the online-softmax :func:`blockwise_sdpa`,
``"blockwise_cv"`` the same tiles with a hand-written backward
(:func:`repro_torch.models.attention_cv.blockwise_sdpa_cv`),
``"blockwise_hp"`` :func:`blockwise_sdpa` (see :func:`self_attention`), and
``"flash"`` runs
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` — the
hand-written forward and backward kernels on CUDA, their plain version on
the CPU.  Cross-attention (the encoder-decoder family) takes ``"ref"`` or,
above ``CROSS_TILE_THRESHOLD`` logits, ``"blockwise"``; flash never serves
it.  Decode attention runs through
:func:`repro_torch.kernels.decode_attention.ops.decode_attention` on CUDA
and its plain version on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention_cv, layers
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30

#: the q and KV tiles of the 'blockwise_cv' backend, which needs the
#: sequence to be a multiple of them (the JAX package's 256 and 256)
CV_TILE = 256


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attn(generator: torch.Generator, cfg: ModelConfig, *,
              cross: bool = False) -> dict:
    """q/k/v/o weights; a cross-attention block (``cross``) has ``n_heads``
    K/V heads and no bias or qk-norm, as in the JAX package."""
    d, hd = cfg.d_model, cfg.hd
    h, k = cfg.n_heads, (cfg.n_heads if cross else cfg.n_kv_heads)
    s = 1.0 / math.sqrt(d)
    dev, dt = generator.device, cfg.dtype
    p = {"wq": layers._normal(generator, (d, h * hd), s, dt),
         "wk": layers._normal(generator, (d, k * hd), s, dt),
         "wv": layers._normal(generator, (d, k * hd), s, dt),
         "wo": layers._normal(generator, (h * hd, d), 1.0 / math.sqrt(h * hd),
                              dt)}
    if cfg.attn_bias and not cross:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((k * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((k * hd,), dtype=dt, device=dev)
    if cfg.qk_norm and not cross:
        p["q_norm"] = {"scale": torch.zeros((hd,), dtype=dt, device=dev)}
        p["k_norm"] = {"scale": torch.zeros((hd,), dtype=dt, device=dev)}
    return p


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, adapters, *,
                 kv_from: Optional[torch.Tensor] = None, cross: bool = False,
                 adapter_rows: Optional[torch.Tensor] = None):
    """Return q (B,S,H,hd), k,v (B,Skv,K,hd) — rope NOT yet applied.  K and
    V project ``kv_from`` (B,Skv,D) where given (cross-attention: the
    encoder's output), else x; ``cross`` gives them ``n_heads`` heads and
    skips the qk-norm."""
    ad = adapters or {}
    sc = cfg.lora_alpha / cfg.lora_rank
    b, s, _ = x.shape
    kv_x = x if kv_from is None else kv_from
    skv = kv_x.shape[1]
    k_heads = cfg.n_heads if cross else cfg.n_kv_heads
    kw = dict(lora_scaling=sc, adapter_rows=adapter_rows)
    q = layers.dense(x, p["wq"], bias=p.get("bq"), adapter=ad.get("wq"),
                     **kw).reshape(b, s, cfg.n_heads, cfg.hd)
    k = layers.dense(kv_x, p["wk"], bias=p.get("bk"), adapter=ad.get("wk"),
                     **kw).reshape(b, skv, k_heads, cfg.hd)
    v = layers.dense(kv_x, p["wv"], bias=p.get("bv"), adapter=ad.get("wv"),
                     **kw).reshape(b, skv, k_heads, cfg.hd)
    if cfg.qk_norm and not cross:
        q = layers.rmsnorm(q, p["q_norm"]["scale"])
        k = layers.rmsnorm(k, p["k_norm"]["scale"])
    return q, k, v


def _rope(cfg: ModelConfig, x: torch.Tensor, positions) -> torch.Tensor:
    if cfg.pos_type == "rope":
        return layers.apply_rope(x, positions, cfg.rope_theta)
    if cfg.pos_type == "mrope":
        return layers.apply_rope(x, positions, cfg.rope_theta,
                                 sections=cfg.mrope_sections)
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
# blockwise SDPA: online softmax over KV chunks, O(bq·bk) logits at a time
# ---------------------------------------------------------------------------

def blockwise_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0, bq: int = 256,
                   bk: int = 256) -> torch.Tensor:
    """The same function as :func:`sdpa` (causal rows are the last ``Sq``
    of the ``Skv``-long sequence), computed a (bq, bk) logits tile at a
    time; KV tiles outside the causal/window band are skipped.  Plain
    PyTorch; autograd keeps each tile's intermediates for the backward."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    bq, bk = min(bq, sq), min(bk, skv)
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kh, g, hd).permute(0, 2, 3, 1, 4).float()
    kt = k.permute(0, 2, 1, 3).float()                    # (B,K,Skv,hd)
    vt = v.permute(0, 2, 1, 3).float()
    off = skv - sq
    chunks = []
    for q0 in range(0, sq, bq):
        qc = qg[:, :, :, q0:q0 + bq] * scale               # (B,K,G,bq,hd)
        n = qc.shape[3]
        qpos = torch.arange(q0, q0 + n, device=q.device) + off
        m_run = torch.full((b, kh, g, n), NEG_INF, device=q.device)
        l_run = torch.zeros((b, kh, g, n), device=q.device)
        acc = torch.zeros((b, kh, g, n, hd), device=q.device)
        for k0 in range(0, skv, bk):
            k1 = min(k0 + bk, skv)
            if causal and (k0 > q0 + off + n - 1 or (
                    window and k1 - 1 <= q0 + off - window)):
                continue                                    # outside the band
            kpos = torch.arange(k0, k1, device=q.device)
            mask = torch.ones((n, k1 - k0), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
                if window:
                    mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.einsum("bkgqd,bksd->bkgqs", qc, kt[:, :, k0:k1])
            s = torch.where(mask, s, torch.full((), NEG_INF,
                                                device=q.device))
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            torch.zeros((), device=q.device))
            l_run = alpha * l_run + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p, vt[:, :, k0:k1])
            m_run = m_new
        chunks.append(acc / l_run.clamp_min(1e-30)[..., None])
    out = torch.cat(chunks, dim=3)                         # (B,K,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# backend registry: every entry point resolves its implementation here
# ---------------------------------------------------------------------------

#: Valid values for ``ModelConfig.attn_impl`` / per-call ``impl=`` overrides.
IMPLS = ("auto", "ref", "blockwise", "blockwise_hp", "blockwise_cv", "flash")

#: "auto" self-attention: materialized-logits reference up to this length,
#: blockwise (online-softmax) beyond it.
AUTO_REF_MAX_SEQ = 2048

#: cross-attention tiles its (Sq, Skv) logits once the product exceeds this
#: (4M f32 entries = 16 MiB of materialized logits per head pair).
CROSS_TILE_THRESHOLD = 4_194_304


def select_impl(cfg: Optional[ModelConfig], seq_len: int, *,
                impl: Optional[str] = None, kv_len: Optional[int] = None,
                kv_valid: bool = False) -> str:
    """Resolve the attention backend for one call site.

    Precedence: explicit ``impl`` kwarg > ``cfg.attn_impl`` > "auto".  The
    returned name is concrete (never "auto").  ``kv_len`` marks the
    non-causal cross-attention path (tile above CROSS_TILE_THRESHOLD);
    ``kv_valid`` marks decode/ring-cache calls whose validity masks only the
    reference SDPA supports.  The same resolution as the JAX package's.
    """
    chosen = impl if impl is not None else (
        cfg.attn_impl if cfg is not None else "auto")
    if chosen not in IMPLS:
        raise ValueError(
            f"unknown attn_impl {chosen!r}; valid: {', '.join(IMPLS)}")
    if kv_valid:
        return "ref"
    if kv_len is not None:
        if chosen in ("ref", "blockwise"):
            return chosen
        return ("blockwise" if seq_len * kv_len > CROSS_TILE_THRESHOLD
                else "ref")
    if chosen == "auto":
        return "ref" if seq_len <= AUTO_REF_MAX_SEQ else "blockwise"
    if chosen in ("blockwise_hp", "blockwise_cv") \
            and seq_len <= AUTO_REF_MAX_SEQ:
        return "ref"            # tiling overhead not worth it at short seq
    return chosen


def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, positions,
                   adapters=None, *, window: int = 0,
                   impl: Optional[str] = None,
                   adapter_rows: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Causal self-attention of a full sequence x (B,S,D) → (B,S,D).
    ``impl`` (None defers to ``cfg.attn_impl``) resolves through
    :func:`select_impl`: 'ref', 'blockwise', 'flash', 'blockwise_cv' (the
    hand-written backward of :mod:`repro_torch.models.attention_cv` when S
    is a multiple of its 256-token tiles, else 'blockwise') or
    'blockwise_hp'; the last two resolve to 'ref' up to AUTO_REF_MAX_SEQ,
    as in the JAX package.  'blockwise_hp' is 'blockwise' after the JAX
    package's ``_head_parallel``, which under a device mesh with a
    ``model`` axis expands GQA K/V to the query heads and hints the head
    dim onto that axis, and without a mesh changes nothing.  The port's
    meshes (:mod:`repro_torch.launch.mesh`) are of one process with no
    partitioner to read such a hint, so here it is 'blockwise', as the JAX
    package's is without a mesh (a reference limit kept, ROADMAP).

    ``adapter_rows`` (B,) switches the q/k/v/o adapters to stacked (m, …)
    factors, sequence ``i`` applying adapter ``adapter_rows[i]``: the
    vectorized clients, whose batches fold into B (attention itself is the
    same per sequence)."""
    q, k, v = _project_qkv(cfg, p, x, adapters, adapter_rows=adapter_rows)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    impl = select_impl(cfg, q.shape[1], impl=impl)
    if impl == "flash":
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    elif impl == "blockwise_cv" and q.shape[1] % CV_TILE == 0:
        out = attention_cv.blockwise_sdpa_cv(q, k, v, True, window, CV_TILE,
                                             CV_TILE)
    elif impl in ("blockwise", "blockwise_cv", "blockwise_hp"):
        out = blockwise_sdpa(q, k, v, causal=True, window=window)
    else:
        out = sdpa(q, k, v, causal=True, window=window)
    b, s = x.shape[:2]
    sc = cfg.lora_alpha / cfg.lora_rank
    ad = adapters or {}
    return layers.dense(out.reshape(b, s, -1), p["wo"], adapter=ad.get("wo"),
                        lora_scaling=sc, adapter_rows=adapter_rows)


def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    enc_out: torch.Tensor, adapters=None, *,
                    impl: Optional[str] = None,
                    adapter_rows: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Bidirectional attention of the decoder's x (B,S,D) over the
    encoder's output (B,F,D), with the block's q/k/v/o adapters; 'ref', or
    'blockwise' above CROSS_TILE_THRESHOLD logits (:func:`select_impl`).
    ``adapter_rows`` (B,) as in :func:`self_attention`: sequence ``i``'s
    queries and its own encoder rows both apply adapter
    ``adapter_rows[i]``."""
    q, k, v = _project_qkv(cfg, p, x, adapters, kv_from=enc_out, cross=True,
                           adapter_rows=adapter_rows)
    impl = select_impl(cfg, q.shape[1], impl=impl, kv_len=k.shape[1])
    if impl == "blockwise":                     # long decoder seq: tile it
        out = blockwise_sdpa(q, k, v, causal=False)
    else:
        out = sdpa(q, k, v, causal=False)
    b, s = x.shape[:2]
    sc = cfg.lora_alpha / cfg.lora_rank
    ad = adapters or {}
    return layers.dense(out.reshape(b, s, -1), p["wo"], adapter=ad.get("wo"),
                        lora_scaling=sc, adapter_rows=adapter_rows)


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
