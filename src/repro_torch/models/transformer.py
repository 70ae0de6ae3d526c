"""Block assembly for attention (full and sliding-window, with a dense or
a Mixture-of-Experts MLP, optionally with cross-attention), RWKV-6 and
RG-LRU stacks: init, the full-sequence forward (training, prefill) and
one-token decode.

Layer stacking follows the config's ``layer_pattern`` exactly as in the JAX
package: ``q = n_layers // len(pattern)`` repetitions of the pattern with
parameters stacked on a leading group axis, plus an unrolled remainder
("tail").  The trees therefore match the JAX ones key for key and shape for
shape; a Python loop over the group axis stands in for ``lax.scan``.
Caches and recurrent state mirror the same (groups, tail) structure.

An ``swa`` block is an ``attn`` block whose self-attention sees the last
``cfg.window`` positions only: the same parameter and adapter trees, the
window passed to training attention, and a decode ring of
``min(window, seq_len)`` slots, as in the JAX package.

An MoE config (``cfg.is_moe``) gives its attention blocks a ``moe``
subtree in place of ``mlp`` (:mod:`repro_torch.models.moe`); the experts
are frozen and take no adapter, and the block's forward returns the
router's aux loss.  An ``rglru`` block (RecurrentGemma) is
``{ln1, rec, ln2, mlp}`` (:mod:`repro_torch.models.rglru`), its adapters on
the recurrence's ``w_in`` / ``w_out`` whatever ``lora_targets`` says.

The encoder-decoder family (whisper-small) builds its decoder blocks with
``cross=True``: ``ln_x`` and an ``xattn`` cross-attention over the
encoder's output after the self-attention, adapted on ``lora_targets``
like ``attn``; and its encoder as a stack of ``causal=False`` blocks
(:func:`block_apply`), which always take the plain :func:`attention.sdpa`
and no adapter.  A cross block's decode cache adds ``xk`` / ``xv``
(B, enc_frames, n_heads, hd), zeros as the JAX package makes them; decode
reads them without writing them, and its cross step applies no adapter
and no bias to ``wq`` / ``wo``, as the JAX package's does.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tri_lora
from repro_torch.models import attention, layers, moe, rglru, rwkv
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


ATTN_KINDS = ("attn", "swa")


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in ATTN_KINDS + ("rwkv6", "rglru") \
            or (cfg.is_moe and kind not in ATTN_KINDS):
        raise ValueError(
            f"block kinds are 'attn' and 'swa' (dense or MoE), 'rwkv6' and "
            f"'rglru'; {cfg.name!r} asks for kind={kind!r} "
            f"moe={cfg.is_moe}")


def _window(cfg: ModelConfig, kind: str) -> int:
    """The attention window of a block: ``cfg.window`` for ``swa``, 0 (the
    whole causal prefix) for ``attn``."""
    return cfg.window if kind == "swa" else 0


# ---------------------------------------------------------------------------
# per-block init
# ---------------------------------------------------------------------------

def _adapter_shapes(cfg: ModelConfig, kind: str, cross: bool = False) -> dict:
    """{module: {target: (d_in, d_out)}} of a block's tri-LoRA adapters;
    ``cross`` adds the ``xattn`` targets (all n_heads wide)."""
    _check_kind(cfg, kind)
    d, hd, h, k, f = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    if kind == "rwkv6":
        # the paper's attention attachment point does not exist; adapt the
        # time-mix r/k/v/o projections instead, whatever lora_targets says
        return {"tm": {t: (d, d) for t in ("wr", "wk", "wv", "wo")}}
    if kind == "rglru":
        rd = cfg.rnn_d
        return {"rec": {"w_in": (d, 2 * rd), "w_out": (rd, d)}}
    shapes = {"wq": (d, h * hd), "wk": (d, k * hd),
              "wv": (d, k * hd), "wo": (h * hd, d)}
    out = {"attn": {t: shapes[t] for t in cfg.lora_targets if t in shapes}}
    if cross:
        xs = {"wq": (d, h * hd), "wk": (d, h * hd),
              "wv": (d, h * hd), "wo": (h * hd, d)}
        out["xattn"] = {t: xs[t] for t in cfg.lora_targets if t in xs}
    if cfg.lora_mlp and not cfg.is_moe:     # the experts stay frozen
        if cfg.mlp_type == "swiglu":
            out["mlp"] = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
        else:
            out["mlp"] = {"w_in": (d, f), "w_out": (f, d)}
    return out


def init_block_adapters(generator: torch.Generator, cfg: ModelConfig,
                        kind: str, *, cross: bool = False) -> dict:
    return {m: {t: tri_lora.init_adapter(generator, din, dout, cfg.lora_rank,
                                         torch.float32)
                for t, (din, dout) in ts.items()}
            for m, ts in _adapter_shapes(cfg, kind, cross).items()}


def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str, *,
               cross: bool = False) -> dict:
    _check_kind(cfg, kind)
    d, nt, dev = cfg.d_model, cfg.norm_type, generator.device
    if kind == "rwkv6":
        return {"ln1": layers.init_norm(d, nt, cfg.dtype, dev),
                "tm": rwkv.init_time_mix(generator, cfg),
                "ln2": layers.init_norm(d, nt, cfg.dtype, dev),
                "cm": rwkv.init_channel_mix(generator, cfg)}
    if kind == "rglru":
        return {"ln1": layers.init_norm(d, nt, cfg.dtype, dev),
                "rec": rglru.init_rglru_block(generator, cfg),
                "ln2": layers.init_norm(d, nt, cfg.dtype, dev),
                "mlp": layers.init_mlp(generator, d, cfg.d_ff, cfg.mlp_type,
                                       cfg.dtype)}
    p = {"ln1": layers.init_norm(d, nt, cfg.dtype, dev),
         "attn": attention.init_attn(generator, cfg),
         "ln2": layers.init_norm(d, nt, cfg.dtype, dev)}
    if cross:
        p["ln_x"] = layers.init_norm(d, nt, cfg.dtype, dev)
        p["xattn"] = attention.init_attn(generator, cfg, cross=True)
    if cfg.is_moe:
        p["moe"] = moe.init_moe(generator, cfg)
    else:
        p["mlp"] = layers.init_mlp(generator, d, cfg.d_ff, cfg.mlp_type,
                                   cfg.dtype)
    return p


# ---------------------------------------------------------------------------
# per-block apply (train)
# ---------------------------------------------------------------------------

def block_apply(cfg: ModelConfig, kind: str, p: dict, ad: Optional[dict],
                x: torch.Tensor, positions, *, enc_out=None,
                causal: bool = True, attn_impl=None,
                use_rwkv_kernel: bool = False,
                adapter_rows: Optional[torch.Tensor] = None) -> tuple:
    """One pre-norm block over a full sequence; ``causal=False`` is the
    encoder's bidirectional attention (plain :func:`attention.sdpa` whatever
    ``attn_impl`` says), and a block with ``xattn`` attends to ``enc_out``
    after its self-attention.  Returns (x, aux): the MoE
    router's auxiliary loss (a scalar, or with ``adapter_rows`` a (B,)
    vector of each sequence's own term, :func:`moe.moe_mlp`'s ``by_row``),
    0 for the other blocks.  ``use_rwkv_kernel`` runs an rwkv6 block's WKV
    recurrence through the forward-only wkv6 kernel (``rwkv.time_mix``).
    ``adapter_rows`` (B,) gives each sequence its own adapter of the
    stacked (m, …) ``ad`` (the adapted projections of every block kind)."""
    _check_kind(cfg, kind)
    ad = ad or {}
    nt = cfg.norm_type
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rwkv6":
        h = layers.norm(x, p["ln1"], nt)
        y, _ = rwkv.time_mix(cfg, p["tm"], h, None, ad.get("tm"),
                             use_kernel=use_rwkv_kernel,
                             adapter_rows=adapter_rows)
        x = x + y
        h = layers.norm(x, p["ln2"], nt)
        y, _ = rwkv.channel_mix(cfg, p["cm"], h, None)
        return x + y, aux
    if kind == "rglru":
        h = layers.norm(x, p["ln1"], nt)
        y, _ = rglru.rglru_block(cfg, p["rec"], h, None, ad.get("rec"),
                                 adapter_rows=adapter_rows)
        x = x + y
        h = layers.norm(x, p["ln2"], nt)
        return x + layers.mlp(h, p["mlp"], cfg.mlp_type), aux
    h = layers.norm(x, p["ln1"], nt)
    if causal:
        x = x + attention.self_attention(cfg, p["attn"], h, positions,
                                         ad.get("attn"),
                                         window=_window(cfg, kind),
                                         impl=attn_impl,
                                         adapter_rows=adapter_rows)
    else:                                        # the encoder: bidirectional
        q, k, v = attention._project_qkv(cfg, p["attn"], h, ad.get("attn"))
        o = attention.sdpa(q, k, v, causal=False)
        b, s = h.shape[:2]
        x = x + layers.dense(o.reshape(b, s, -1), p["attn"]["wo"],
                             adapter=(ad.get("attn") or {}).get("wo"),
                             lora_scaling=cfg.lora_alpha / cfg.lora_rank)
    if "xattn" in p:
        h = layers.norm(x, p["ln_x"], nt)
        x = x + attention.cross_attention(cfg, p["xattn"], h, enc_out,
                                          ad.get("xattn"),
                                          adapter_rows=adapter_rows)
    h = layers.norm(x, p["ln2"], nt)
    if cfg.is_moe:
        y, aux = moe.moe_mlp(cfg, p["moe"], h,
                             by_row=adapter_rows is not None)
    else:
        y = layers.mlp(h, p["mlp"], cfg.mlp_type, adapters=ad.get("mlp"),
                       lora_scaling=cfg.lora_alpha / cfg.lora_rank,
                       adapter_rows=adapter_rows)
    return x + y, aux


# ---------------------------------------------------------------------------
# per-block decode (one token, carries the cache)
# ---------------------------------------------------------------------------

def block_decode(cfg: ModelConfig, kind: str, p: dict, ad: Optional[dict],
                 cache: dict, x: torch.Tensor, positions,
                 adapter_rows: Optional[torch.Tensor] = None):
    _check_kind(cfg, kind)
    ad = ad or {}
    nt = cfg.norm_type
    if kind in ("rwkv6", "rglru") and adapter_rows is not None:
        raise NotImplementedError(
            f"grouped adapter banks only support attention blocks, as in "
            f"the JAX package; got layer kind {kind!r} (ROADMAP, Queue 1: "
            f"'reference limits kept')")
    if kind == "rwkv6":
        h = layers.norm(x, p["ln1"], nt)
        y, tm = rwkv.time_mix(cfg, p["tm"], h, cache["tm"], ad.get("tm"))
        x = x + y
        h = layers.norm(x, p["ln2"], nt)
        y, cm = rwkv.channel_mix(cfg, p["cm"], h, cache["cm"])
        return x + y, {"tm": tm, "cm": cm}
    if kind == "rglru":
        h = layers.norm(x, p["ln1"], nt)
        y, state = rglru.rglru_block(cfg, p["rec"], h, cache, ad.get("rec"))
        x = x + y
        h = layers.norm(x, p["ln2"], nt)
        return x + layers.mlp(h, p["mlp"], cfg.mlp_type), state
    h = layers.norm(x, p["ln1"], nt)
    y, new_cache = attention.decode_self_attention(
        cfg, p["attn"], h, cache, positions, ad.get("attn"),
        adapter_rows=adapter_rows)
    x = x + y
    if "xattn" in p:              # no adapter, no bias, as in the JAX package
        b = x.shape[0]
        h = layers.norm(x, p["ln_x"], nt)
        q = layers.dense(h, p["xattn"]["wq"]).reshape(b, 1, cfg.n_heads,
                                                      cfg.hd)
        o = attention.sdpa(q, cache["xk"], cache["xv"], causal=False)
        x = x + layers.dense(o.reshape(b, 1, -1), p["xattn"]["wo"])
        new_cache["xk"], new_cache["xv"] = cache["xk"], cache["xv"]
    h = layers.norm(x, p["ln2"], nt)
    if cfg.is_moe:              # one token a group: capacity 1 per expert
        y, _ = moe.moe_mlp(cfg, p["moe"], h)
    else:
        y = layers.mlp(h, p["mlp"], cfg.mlp_type, adapters=ad.get("mlp"),
                       lora_scaling=cfg.lora_alpha / cfg.lora_rank,
                       adapter_rows=adapter_rows)
    return x + y, new_cache


# ---------------------------------------------------------------------------
# stack init: (groups stacked on a leading axis, tail unrolled)
# ---------------------------------------------------------------------------

def _stacked(n: int, make: Callable[[int], Any]) -> Any:
    """Tree whose leaves are (n, …) tensors with ``[i]`` equal to the leaves
    of ``make(i)``; filled one slice at a time so that a full-size model
    never holds two copies of its weights."""
    first = make(0)
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)

    def put(i, tree):
        tree_map(lambda dst, src: dst[i].copy_(src), out, tree)

    put(0, first)
    del first
    for i in range(1, n):
        put(i, make(i))
    return out


def init_stack(generator: torch.Generator, cfg: ModelConfig, *,
               cross: bool = False) -> tuple:
    """Returns (groups_params, tail_params) following cfg.stack_plan()."""
    q, pattern, rem = cfg.stack_plan()
    groups = _stacked(q, lambda _: {
        str(i): init_block(generator, cfg, kind, cross=cross)
        for i, kind in enumerate(pattern)}) if q else None
    tail = tuple(init_block(generator, cfg, kind, cross=cross)
                 for kind in rem)
    return groups, tail


def init_stack_adapters(generator: torch.Generator, cfg: ModelConfig, *,
                        cross: bool = False) -> tuple:
    q, pattern, rem = cfg.stack_plan()
    groups = _stacked(q, lambda _: {
        str(i): init_block_adapters(generator, cfg, kind, cross=cross)
        for i, kind in enumerate(pattern)}) if q else None
    tail = tuple(init_block_adapters(generator, cfg, kind, cross=cross)
                 for kind in rem)
    return groups, tail


def init_stack_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                     device, cross: bool = False) -> tuple:
    q, pattern, rem = cfg.stack_plan()

    def block_cache(kind):
        _check_kind(cfg, kind)
        if kind == "rwkv6":
            return rwkv.init_state(cfg, batch, device=device)
        if kind == "rglru":
            return rglru.init_state(cfg, batch, device=device)
        c = attention.init_kv_cache(cfg, batch, seq_len, device=device,
                                    window=_window(cfg, kind))
        if cross:
            shape = (batch, cfg.enc_frames, cfg.n_heads, cfg.hd)
            c["xk"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
            c["xv"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        return c

    groups = ({str(i): tree_map(
        lambda t: t.new_zeros((q,) + tuple(t.shape)), block_cache(kind))
        for i, kind in enumerate(pattern)} if q else None)
    tail = tuple(block_cache(kind) for kind in rem)
    return groups, tail


# ---------------------------------------------------------------------------
# stack apply and decode
# ---------------------------------------------------------------------------

def _at(tree: Any, i: int) -> Any:
    return tree_map(lambda t: t[i], tree)


def _at_layer(tree: Any, layer: int) -> Any:
    """Layer ``layer`` of every client of a stacked client tree (leaves
    (m, q, …) → (m, …)): strided views, no copy."""
    return tree_map(lambda t: t[:, layer], tree)


def run_stack(cfg: ModelConfig, groups_p, tail_p, groups_ad, tail_ad,
              x: torch.Tensor, positions, *, enc_out=None,
              causal: bool = True, attn_impl=None,
              use_rwkv_kernel: bool = False,
              adapter_rows: Optional[torch.Tensor] = None) -> tuple:
    """Train-time forward through the whole stack.  Returns (x, aux_sum).
    ``attn_impl=None`` defers the backend choice to ``cfg.attn_impl``
    (``attention.select_impl``).  A Python loop over the group axis stands
    in for ``lax.scan``.  With ``cfg.remat`` and autograd recording, each
    iteration of that loop (one pass through ``pattern``) runs under
    non-reentrant ``torch.utils.checkpoint``, as the JAX package wraps the
    scanned group in ``jax.checkpoint``: only the group's input is kept
    and its forward runs again in the backward.  The tail blocks are not
    wrapped, and nothing is under ``torch.no_grad`` (eval, prefill).
    ``enc_out`` (the encoder's output, for blocks with cross-attention)
    and ``causal`` (False: the encoder's blocks) reach every block, inside
    the checkpoint too.

    With ``adapter_rows`` (B,) the adapter trees are a STACKED client state
    — groups leaves (m, q, …), tail leaves (m, …), the client axis first as
    in ``core.client_batch`` (unlike ``run_stack_decode``'s (q, m, …) bank)
    — and sequence ``i`` applies client ``adapter_rows[i]``'s adapters;
    an MoE stack's aux is then the (B,) vector of each sequence's own sum
    over the layers (:func:`block_apply`)."""
    q, pattern, rem = cfg.stack_plan()
    kw = dict(enc_out=enc_out, causal=causal, attn_impl=attn_impl,
              use_rwkv_kernel=use_rwkv_kernel, adapter_rows=adapter_rows)
    layer_of = _at if adapter_rows is None else _at_layer

    def group(h, aux, layer):
        for i, kind in enumerate(pattern):
            key = str(i)
            gad = groups_ad[key] if groups_ad is not None else None
            h, a = block_apply(cfg, kind, _at(groups_p[key], layer),
                               layer_of(gad, layer), h, positions, **kw)
            aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if groups_p is not None:
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in range(q):
            if remat:
                x, aux = checkpoint(group, x, aux, layer,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = group(x, aux, layer)
    for i, kind in enumerate(rem):
        x, a = block_apply(cfg, kind, tail_p[i], tail_ad[i], x, positions,
                           **kw)
        aux = aux + a
    return x, aux


def _restack(old: torch.Tensor, *new: torch.Tensor) -> torch.Tensor:
    """The stacked (q, …) leaf of a new groups cache: ``old`` itself where
    every layer's new value is its own slice of ``old`` (updated in place),
    else the new values stacked."""
    if all(n.data_ptr() == old[i].data_ptr() and n.shape == old[i].shape
           for i, n in enumerate(new)):
        return old
    return torch.stack(new)


def run_stack_decode(cfg: ModelConfig, groups_p, tail_p, groups_ad, tail_ad,
                     groups_cache, tail_cache, x: torch.Tensor, positions,
                     adapter_rows=None):
    """One-token decode through the stack; returns (x, new caches).

    With ``adapter_rows`` (B,) the adapter trees carry a stacked bank axis
    — groups leaves (q, m, …), tail leaves (m, …), see
    ``AdapterBank.decode_tree`` — and each batch row applies its own bank
    row.  K/V buffers are written in place (see
    ``attention.decode_self_attention``); every other leaf of the new
    groups cache (ring positions, RWKV shift and WKV states) is restacked
    from the layers' new values, so the tree equals the JAX package's."""
    q, pattern, rem = cfg.stack_plan()
    new_groups_cache = None
    if groups_p is not None:
        new_layers: dict = {str(i): [] for i in range(len(pattern))}
        for layer in range(q):
            for i, kind in enumerate(pattern):
                key = str(i)
                gad = groups_ad[key] if groups_ad is not None else None
                x, c = block_decode(cfg, kind, _at(groups_p[key], layer),
                                    _at(gad, layer),
                                    _at(groups_cache[key], layer), x,
                                    positions, adapter_rows=adapter_rows)
                new_layers[key].append(c)
        new_groups_cache = {key: tree_map(_restack, groups_cache[key],
                                          *new_layers[key])
                            for key in groups_cache}
    new_tail = []
    for i, kind in enumerate(rem):
        x, c = block_decode(cfg, kind, tail_p[i], tail_ad[i], tail_cache[i],
                            x, positions, adapter_rows=adapter_rows)
        new_tail.append(c)
    return x, new_groups_cache, tuple(new_tail)
