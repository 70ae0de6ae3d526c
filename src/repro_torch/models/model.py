"""Top-level model API of the port: init and one-token decode (dense).

params = {'base': …frozen…, 'adapter': …tri-LoRA…}, with the JAX package's
key paths and shapes (``repro_torch.convert`` moves a JAX tree across).

decode:  {'token': (B,1) int, 'positions': (B,1) int} + the cache tree from
:func:`init_decode_cache`.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random params drawn from ``generator``, on its device."""
    if cfg.enc_dec or cfg.vision_patches or cfg.pos_type == "mrope":
        raise NotImplementedError(
            f"{cfg.name!r}: only decoder-only text models are ported so far")
    dev = generator.device
    base: dict = {"embed": layers.init_embedding(generator, cfg.padded_vocab,
                                                 cfg.d_model, cfg.dtype),
                  "final_norm": layers.init_norm(cfg.d_model, cfg.norm_type,
                                                 cfg.dtype, dev)}
    base["groups"], base["tail"] = transformer.init_stack(generator, cfg)
    if cfg.pos_type == "learned":
        base["pos_embed"] = layers._normal(
            generator, (cfg.max_target_positions, cfg.d_model), 0.02,
            cfg.dtype)
    ag, at = transformer.init_stack_adapters(generator, cfg)
    return {"base": base, "adapter": {"groups": ag, "tail": at}}


def _none_adapters_like(cfg: ModelConfig, has_groups: bool):
    """Adapter placeholders (all None) matching the stack structure."""
    _, pattern, rem = cfg.stack_plan()
    groups = {str(i): None for i in range(len(pattern))} if has_groups else None
    return groups, tuple(None for _ in rem)


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                      device) -> dict:
    g, t = transformer.init_stack_cache(cfg, batch, seq_len, device=device)
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
        x = x + base["pos_embed"][positions.long()]
    x, new_g, new_t = transformer.run_stack_decode(
        cfg, base["groups"], base["tail"], adapter["groups"], adapter["tail"],
        cache["groups"], cache["tail"], x, positions,
        adapter_rows=adapter_rows)
    x = layers.norm(x, base["final_norm"], cfg.norm_type)
    logits = layers.unembed(x, base["embed"], cfg.vocab_size)
    if not pad_vocab and cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits, {"groups": new_g, "tail": new_t}
