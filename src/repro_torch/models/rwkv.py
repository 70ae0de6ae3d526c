"""RWKV-6 "Finch" block — attention-free token mixing with data-dependent
decay (arXiv:2404.05892); PyTorch port of ``repro.models.rwkv``.

Time-mix: data-dependent lerp (ddlerp) of (x_t, x_{t-1}) produces r,k,v,w,g;
the WKV recurrence keeps a per-head (hd × hd) state:

    y_t = r_t · (S_{t-1} + diag(u)·k_t·v_tᵀ)
    S_t = diag(w_t)·S_{t-1} + k_t·v_tᵀ          w_t = exp(-exp(ŵ_t)) ∈ (0,1)

Channel-mix: squared-ReLU two-layer MLP with receptance gating.

Tri-LoRA attaches to the r/k/v/o projections of the time-mix (they go
through ``layers.dense``, so on the card they run the tri-LoRA kernels,
and their grouped forms when the clients' adapters are stacked and each
sequence names its own: ``adapter_rows``); the other projections stay
plain ``x @ W``, as in the JAX package.

The WKV recurrence runs through the wkv6 kernel with ``use_kernel=True``
(:mod:`repro_torch.kernels.rwkv6`, forward only), else through the
log-space chunked form for T > 256 and the per-step scan otherwise.
Decode carries (shift states, WKV state) — O(1) per token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

MIX_LORA = 32   # ddlerp low-rank width
W_LORA = 64     # decay low-rank width


def init_time_mix(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    dt, dev = cfg.dtype, generator.device

    def normal(*shape):
        return layers._normal(generator, shape, s, dt)

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    return {
        "mu_x": full((d,), 0.0),
        "mu": full((5, d), 0.0),                            # r,k,v,w,g lerp bases
        "mix_a": normal(d, 5, MIX_LORA),
        "mix_b": full((5, MIX_LORA, d), 0.0),
        "w0": full((d,), -6.0),                             # slow decay at init
        "w_a": normal(d, W_LORA),
        "w_b": full((W_LORA, d), 0.0),
        "u": full((h, hd), 0.0),
        "wr": normal(d, d),
        "wk": normal(d, d),
        "wv": normal(d, d),
        "wg": normal(d, d),
        "wo": normal(d, d),
        "ln_x": full((d,), 1.0),
    }


def init_channel_mix(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt, dev = cfg.dtype, generator.device
    return {
        "mu_k": torch.zeros((d,), dtype=dt, device=dev),
        "mu_r": torch.zeros((d,), dtype=dt, device=dev),
        "wk": layers._normal(generator, (d, f), 1.0 / math.sqrt(d), dt),
        "wv": layers._normal(generator, (f, d), 1.0 / math.sqrt(f), dt),
        "wr": layers._normal(generator, (d, d), 1.0 / math.sqrt(d), dt),
    }


def _ddlerp(p: dict, x: torch.Tensor, xx: torch.Tensor) -> list:
    """Data-dependent lerp producing the five mixed inputs (r,k,v,w,g)."""
    base = x + xx * p["mu_x"]
    lora = torch.tanh(torch.einsum("...d,dfl->...fl", base, p["mix_a"]))
    delta = torch.einsum("...fl,fld->...fd", lora, p["mix_b"])  # (...,5,d)
    mixed = x[..., None, :] + xx[..., None, :] * (p["mu"] + delta)
    return [mixed[..., i, :] for i in range(5)]


def _rkvwg(cfg: ModelConfig, p: dict, x: torch.Tensor, xx: torch.Tensor,
           adapters=None, adapter_rows=None):
    ad = adapters or {}
    sc = cfg.lora_alpha / cfg.lora_rank
    xr, xk, xv, xw, xg = _ddlerp(p, x, xx)
    r = layers.dense(xr, p["wr"], adapter=ad.get("wr"), lora_scaling=sc,
                     adapter_rows=adapter_rows)
    k = layers.dense(xk, p["wk"], adapter=ad.get("wk"), lora_scaling=sc,
                     adapter_rows=adapter_rows)
    v = layers.dense(xv, p["wv"], adapter=ad.get("wv"), lora_scaling=sc,
                     adapter_rows=adapter_rows)
    g = F.silu((xg @ p["wg"]).float())
    w_hat = p["w0"].float() + (torch.tanh(xw @ p["w_a"]) @ p["w_b"]).float()
    w = torch.exp(-torch.exp(w_hat))                          # (…, d) ∈ (0,1)
    return r, k, v, w, g


def wkv_scan(r, k, v, w, u, state):
    """Reference WKV recurrence, one time step at a time.

    r,k,v,w: (B,T,H,hd) — w already in (0,1);  u: (H,hd);
    state: (B,H,hd,hd) carried (key-dim × value-dim).
    Returns y (B,T,H,hd) f32, new state (f32).
    """
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t],
                               s + uf[..., :, None] * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv_chunked(r, k, v, w, u, state, chunk: int = 64):
    """Chunked WKV (the math of the JAX package's Pallas kernel, in plain
    ops): a loop over time chunks with dense intra-chunk algebra.
    Log-space decay keeps every exponent ≤ 0.  Time is padded to a chunk
    multiple with w = 1 (no decay) and k = 0 (no state write)."""
    b, t, h, hd = r.shape
    chunk = min(chunk, t)
    pad = (-t) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    tt = t + pad
    n_chunks = tt // chunk
    rf, kf, vf, wf = (a.float().transpose(1, 2)
                      .reshape(b * h, n_chunks, chunk, hd)
                      for a in (r, k, v, w))
    uf = u.float().expand(b, h, hd).reshape(b * h, hd)
    s = state.float().reshape(b * h, hd, hd)

    t_idx = torch.arange(chunk, device=r.device)
    strict = (t_idx[:, None] > t_idx[None, :])[None, :, :, None]  # (1,L,L,1)
    ys = []
    for c in range(n_chunks):
        rc, kc, vc, wc = rf[:, c], kf[:, c], vf[:, c], wf[:, c]  # (BH,L,hd)
        lw = torch.cumsum(torch.log(torch.clamp_min(wc, 1e-30)), dim=1)
        lw_prev = torch.cat([torch.zeros_like(lw[:, :1]), lw[:, :-1]], dim=1)
        y_inter = torch.einsum("zti,zij->ztj", rc * torch.exp(lw_prev), s)
        expo = lw_prev[:, :, None, :] - lw[:, None, :, :]       # (BH,L,L,hd)
        e = torch.where(strict, torch.exp(torch.clamp_max(expo, 0.0)), 0.0)
        att = torch.einsum("zti,zsi,ztsi->zts", rc, kc, e)
        diag = torch.sum(rc * uf[:, None, :] * kc, dim=-1)      # (BH,L)
        ys.append(y_inter + torch.einsum("zts,zsj->ztj", att, vc)
                  + diag[..., None] * vc)
        decay_all = torch.exp(lw[:, -1])                        # (BH,hd)
        k_scaled = kc * torch.exp(lw[:, -1][:, None, :] - lw)
        s = decay_all[:, :, None] * s + torch.einsum("zti,ztj->zij",
                                                     k_scaled, vc)
    y = torch.stack(ys, dim=1).reshape(b, h, tt, hd).transpose(1, 2)[:, :t]
    return y, s.reshape(b, h, hd, hd)


def time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, state,
             adapters=None, *, use_kernel: bool = False, adapter_rows=None):
    """x (B,T,D); state {'shift': (B,D), 'wkv': (B,H,hd,hd)} or None (zeros).
    ``adapter_rows`` (B,) int: ``adapters`` are stacked (m, …) client
    adapters and sequence ``i`` applies client ``adapter_rows[i]``'s in the
    r/k/v/o projections (the grouped tri-LoRA kernels on the card).
    Returns (out (B,T,D), new state)."""
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    if state is None:
        state = {"shift": x.new_zeros((b, d)),
                 "wkv": torch.zeros((b, h, hd, hd), dtype=torch.float32,
                                    device=x.device)}
    prev = torch.cat([state["shift"][:, None], x[:, :-1]], dim=1)
    xx = prev - x
    r, k, v, w, g = _rkvwg(cfg, p, x, xx, adapters, adapter_rows)
    rh, kh, vh, wh = (a.reshape(b, t, h, hd) for a in (r, k, v, w))
    if use_kernel:
        from repro_torch.kernels.rwkv6 import ops as wkv_ops
        y, new_wkv = wkv_ops.wkv6(rh, kh, vh, wh, p["u"], state["wkv"])
    elif t > 256:
        y, new_wkv = wkv_chunked(rh, kh, vh, wh, p["u"], state["wkv"])
    else:
        y, new_wkv = wkv_scan(rh, kh, vh, wh, p["u"], state["wkv"])
    y = layers.group_rmsnorm(y.reshape(b, t, d), p["ln_x"], h)
    y = (y.float() * g).to(x.dtype)
    sc = cfg.lora_alpha / cfg.lora_rank
    ad = adapters or {}
    out = layers.dense(y, p["wo"], adapter=ad.get("wo"), lora_scaling=sc,
                       adapter_rows=adapter_rows)
    return out, {"shift": x[:, -1], "wkv": new_wkv}


def channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, state):
    """state: {'shift': (B,D)} or None."""
    b, t, d = x.shape
    if state is None:
        state = {"shift": x.new_zeros((b, d))}
    prev = torch.cat([state["shift"][:, None], x[:, :-1]], dim=1)
    xx = prev - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    k = torch.square(torch.relu((xk @ p["wk"]).float()))
    out = torch.sigmoid((xr @ p["wr"]).float()) * \
        (k.to(x.dtype) @ p["wv"]).float()
    return out.to(x.dtype), {"shift": x[:, -1]}


def init_state(cfg: ModelConfig, batch: int, *, device) -> dict:
    h, hd, d = cfg.n_heads, cfg.hd, cfg.d_model
    return {
        "tm": {"shift": torch.zeros((batch, d), dtype=cfg.dtype,
                                    device=device),
               "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                                  device=device)},
        "cm": {"shift": torch.zeros((batch, d), dtype=cfg.dtype,
                                    device=device)},
    }
