"""Top-level model API of the port: init, the full-sequence forward and
loss, and one-token decode (dense, MoE, RWKV-6 and RG-LRU hybrid
decoders, the encoder-decoder family and the VLM family).

params = {'base': …frozen…, 'adapter': …tri-LoRA…}, with the JAX package's
key paths and shapes (``repro_torch.convert`` moves a JAX tree across).

batch:   {'tokens': (B,S) int, 'labels': (B,S) int (-1 = ignore)}, optional
         'positions' (B,S) — (B,P+S,3) (t, h, w) for M-RoPE, covering the
         vision prefix; ['vision': (B,P,D)] (stub patch embeddings,
         prepended: early fusion), ['frames': (B,F,D)] (stub audio frame
         embeddings, the encoder's input).
decode:  {'token': (B,1) int, 'positions': (B,1) or (B,1,3) int} + the cache
tree from :func:`init_decode_cache`.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config: ``n_enc_layers`` full-attention MHA layers."""
    return cfg.with_overrides(n_layers=cfg.n_enc_layers,
                              layer_pattern=("attn",), window=0,
                              n_kv_heads=cfg.n_heads)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random params drawn from ``generator``, on its device; an
    encoder-decoder config adds the ``encoder`` subtree (its own stack,
    ``final_norm`` and ``pos_embed``) and cross-attention on the decoder's
    blocks and adapters."""
    dev = generator.device
    base: dict = {"embed": layers.init_embedding(generator, cfg.padded_vocab,
                                                 cfg.d_model, cfg.dtype),
                  "final_norm": layers.init_norm(cfg.d_model, cfg.norm_type,
                                                 cfg.dtype, dev)}
    base["groups"], base["tail"] = transformer.init_stack(
        generator, cfg, cross=cfg.enc_dec)
    if cfg.pos_type == "learned":
        base["pos_embed"] = layers._normal(
            generator, (cfg.max_target_positions, cfg.d_model), 0.02,
            cfg.dtype)
    if cfg.enc_dec:
        eg, et = transformer.init_stack(generator, _enc_cfg(cfg))
        base["encoder"] = {
            "groups": eg, "tail": et,
            "final_norm": layers.init_norm(cfg.d_model, cfg.norm_type,
                                           cfg.dtype, dev),
            "pos_embed": layers._normal(generator,
                                        (cfg.enc_frames, cfg.d_model), 0.02,
                                        cfg.dtype)}
    ag, at = transformer.init_stack_adapters(generator, cfg,
                                             cross=cfg.enc_dec)
    return {"base": base, "adapter": {"groups": ag, "tail": at}}


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on ``meta``: see :func:`abstract_params`."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


class _NoDraws(TorchFunctionMode):
    """Drops the ``generator`` of every factory call, so that a draw on
    ``meta`` allocates nothing and consumes no generator state."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        return func(*args, **kwargs)


def abstract_params(cfg: ModelConfig) -> dict:
    """:func:`init_params`' tree on ``meta``: every leaf's shape and dtype,
    no allocation and no draw (the dry run's and the pod-stacked helpers'
    stand-ins, as the JAX package's ``eval_shape``)."""
    with torch.device("meta"), _NoDraws():
        return init_params(cfg, _MetaGenerator())


def _none_adapters_like(cfg: ModelConfig, has_groups: bool):
    """Adapter placeholders (all None) matching the stack structure."""
    _, pattern, rem = cfg.stack_plan()
    groups = {str(i): None for i in range(len(pattern))} if has_groups else None
    return groups, tuple(None for _ in rem)


def no_adapter(cfg: ModelConfig) -> dict:
    """An adapter tree that adapts nothing (the frozen backbone)."""
    groups, tail = _none_adapters_like(cfg, cfg.stack_plan()[0] > 0)
    return {"groups": groups, "tail": tail}


def encode(cfg: ModelConfig, base: dict, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over stub frame embeddings (B,F,D): its learned
    positions, ``n_enc_layers`` bidirectional blocks (plain
    ``attention.sdpa``, no adapter), its final norm."""
    enc = base["encoder"]
    ecfg = _enc_cfg(cfg)
    x = frames.to(cfg.dtype) + enc["pos_embed"][None, :frames.shape[1]]
    ad_g, ad_t = _none_adapters_like(ecfg, enc["groups"] is not None)
    x, _ = transformer.run_stack(ecfg, enc["groups"], enc["tail"], ad_g,
                                 ad_t, x, None, causal=False)
    return layers.norm(x, enc["final_norm"], cfg.norm_type)


def client_rows(m: int, b: int, device) -> torch.Tensor:
    """The ``adapter_rows`` of m clients' batches of b sequences folded
    client-major into one batch of m·b: (m·b,) int32, client i's rows
    i·b … i·b + b − 1.  Built by expanding an arange: no host sync, so it
    can be captured in a CUDA graph."""
    return torch.arange(m, dtype=torch.int32, device=device)[:, None].expand(
        m, b).reshape(-1)


def forward_hidden(cfg: ModelConfig, base: dict, adapter: dict, batch: dict,
                   *, attn_impl: str | None = None,
                   use_rwkv_kernel: bool = False,
                   adapter_rows: torch.Tensor | None = None):
    """Embeddings → stack → final norm.  Returns (hidden (B,P+S,D), aux,
    n_prefix = P) as the JAX package does: a VLM batch's ``vision`` (B,P,D)
    goes in front of the text embeddings (its ``positions`` cover all P+S
    tokens), and an encoder-decoder batch's ``frames`` go through
    :func:`encode` first.  Learned positions of a (…, 3) M-RoPE position
    tensor take its first component.  ``attn_impl=None`` defers to
    ``cfg.attn_impl`` (``attention.select_impl``); ``use_rwkv_kernel`` runs
    the WKV recurrence of rwkv6 blocks through the forward-only wkv6
    kernel (a gradient through it raises, as in the JAX package).

    ``adapter_rows`` (B,) int: ``adapter`` is a stacked client state
    (leaves (m, …), the client axis first; see ``transformer.run_stack``)
    and sequence ``i`` applies client ``adapter_rows[i]``'s adapter, -1
    none — the JAX package's ``jax.vmap`` over clients with their batches
    folded into B (:func:`client_rows`)."""
    tokens = batch["tokens"]
    x = layers.embed(tokens, base["embed"])
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device).expand(tokens.shape)
    if cfg.pos_type == "learned":
        x = x + base["pos_embed"][_first_component(positions).long()]
    n_prefix = 0
    if cfg.vision_patches and "vision" in batch:
        x = torch.cat([batch["vision"].to(x.dtype), x], dim=1)
        n_prefix = batch["vision"].shape[1]
    enc_out = encode(cfg, base, batch["frames"]) if cfg.enc_dec else None
    x, aux = transformer.run_stack(
        cfg, base["groups"], base["tail"], adapter["groups"], adapter["tail"],
        x, positions, enc_out=enc_out, attn_impl=attn_impl,
        use_rwkv_kernel=use_rwkv_kernel, adapter_rows=adapter_rows)
    x = layers.norm(x, base["final_norm"], cfg.norm_type)
    return x, aux, n_prefix


def _first_component(positions: torch.Tensor) -> torch.Tensor:
    return positions if positions.dim() == 2 else positions[..., 0]


def forward(cfg: ModelConfig, base: dict, adapter: dict, batch: dict,
            pad_vocab: bool = False, **kw) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Returns (logits f32 over the TEXT positions (B,S,vocab) —
    (B,S,padded_vocab) with -1e30 pad logits when ``pad_vocab`` — and the
    aux loss)."""
    x, aux, n_prefix = forward_hidden(cfg, base, adapter, batch, **kw)
    x = x[:, n_prefix:]
    logits = layers.unembed(x, base["embed"], cfg.vocab_size)
    if not pad_vocab and cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits, aux


#: above S·V = _CE_CHUNK_THRESHOLD (and S a multiple of _CE_CHUNK) the loss
#: runs over checkpointed sequence chunks, as in the JAX package
_CE_CHUNK = 512
_CE_CHUNK_THRESHOLD = 2 ** 28


def _ce_terms(cfg: ModelConfig, hidden: torch.Tensor, table: torch.Tensor,
              labels: torch.Tensor) -> tuple:
    """(nll·w, correct·w, w) per token of one hidden chunk (B, s), with
    w = 1 where the label is >= 0."""
    logits = layers.unembed(hidden, table, cfg.vocab_size)    # (B, s, Vp)
    weights = (labels >= 0).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0).long()[..., None])[
        ..., 0]
    correct = (torch.argmax(logits, -1) == labels).float() * weights
    return nll * weights, correct, weights


def _loss_terms(cfg: ModelConfig, hidden: torch.Tensor, table: torch.Tensor,
                labels: torch.Tensor) -> tuple:
    """:func:`_ce_terms` of the whole sequence; above the chunk threshold
    computed one ``_CE_CHUNK``-token chunk at a time, each under
    ``torch.utils.checkpoint`` while autograd records, so that no chunk's
    (B, _CE_CHUNK, Vp) logits stay alive for the backward."""
    s = hidden.shape[1]
    if not (s * cfg.padded_vocab > _CE_CHUNK_THRESHOLD
            and s % _CE_CHUNK == 0):
        return _ce_terms(cfg, hidden, table, labels)
    remat = torch.is_grad_enabled()
    parts = [checkpoint(_ce_terms, cfg, h, table, lab, use_reentrant=False,
                        preserve_rng_state=False)
             if remat else _ce_terms(cfg, h, table, lab)
             for h, lab in zip(hidden.split(_CE_CHUNK, 1),
                               labels.split(_CE_CHUNK, 1))]
    return tuple(torch.cat(t, dim=1) for t in zip(*parts))


def loss_fn(cfg: ModelConfig, adapter: dict, base: dict, batch: dict,
            *, adapter_rows: torch.Tensor | None = None,
            **kw) -> tuple[torch.Tensor, dict]:
    """Causal-LM cross entropy over labels >= 0; returns (loss, {'ce',
    'aux', 'acc'}).  Adapter-first as in the JAX package.  The loss is
    over the text positions (a vision prefix is sliced off first).  Above
    S·V = 2^28 it runs over checkpointed 512-token chunks
    (:func:`_loss_terms`), so the (B, S, V) logits never materialize.

    With ``adapter_rows`` (:func:`forward_hidden`) the batch holds the
    folded batches of the m clients of the stacked ``adapter``, and loss,
    ce and acc are (m,) vectors, client i's over its own sequences — what
    ``jax.vmap`` of this function over the clients returns.  Their SUM is
    the scalar to differentiate: each client's adapter then gets exactly
    its own gradient (a mean over the m·B batch would scale it by 1/m).
    So is aux: client i's MoE aux is the mean over its own sequences'
    terms, as its single-client run computes it (a row of -1 belongs to no
    client), and the dense stacks' 0 a vector of zeros."""
    hidden, aux, n_prefix = forward_hidden(cfg, base, adapter, batch,
                                           adapter_rows=adapter_rows, **kw)
    terms = _loss_terms(cfg, hidden[:, n_prefix:], base["embed"],
                        batch["labels"])
    if adapter_rows is None:
        nll_sum, corr_sum, w_sum = (t.sum() for t in terms)
    else:                        # per client: a 0/1 (m, B) client matrix
        m = tree_leaves(adapter)[0].shape[0]
        own = (adapter_rows.long()[None, :] == torch.arange(
            m, device=hidden.device)[:, None]).float()
        nll_sum, corr_sum, w_sum = (own @ t.sum(-1) for t in terms)
        aux = (own @ aux.expand(own.shape[1])) / own.sum(-1).clamp_min(1.0)
    denom = w_sum.clamp_min(1.0)
    ce = nll_sum / denom
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "acc": corr_sum / denom}


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                      device) -> dict:
    """The decode cache; an encoder-decoder config's blocks also hold the
    cross K/V ``xk`` / ``xv``, zeros (the JAX package never fills them
    outside its tests; a caller fills them from :func:`encode`'s
    output)."""
    g, t = transformer.init_stack_cache(cfg, batch, seq_len, device=device,
                                        cross=cfg.enc_dec)
    return {"groups": g, "tail": t}


def decode_step(cfg: ModelConfig, base: dict, adapter: dict, cache: dict,
                batch: dict, pad_vocab: bool = False,
                adapter_rows=None) -> tuple[torch.Tensor, dict]:
    """One new token against the cache.  Returns (logits (B,1,V) f32, new
    cache); the cache's K/V buffers are updated in place.  ``pad_vocab``
    keeps the padded vocab dim.  ``adapter_rows`` (B,) int32 switches
    ``adapter`` to a stacked bank (``AdapterBank.decode_tree()``): each batch
    row applies its own adapter row, and cache ``idx`` leaves must be
    per-row (B,) vectors (ragged decode)."""
    token = batch["token"]
    positions = batch["positions"]
    x = layers.embed(token, base["embed"])
    if cfg.pos_type == "learned":
        x = x + base["pos_embed"][_first_component(positions).long()]
    x, new_g, new_t = transformer.run_stack_decode(
        cfg, base["groups"], base["tail"], adapter["groups"], adapter["tail"],
        cache["groups"], cache["tail"], x, positions,
        adapter_rows=adapter_rows)
    x = layers.norm(x, base["final_norm"], cfg.norm_type)
    logits = layers.unembed(x, base["embed"], cfg.vocab_size)
    if not pad_vocab and cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits, {"groups": new_g, "tail": new_t}
