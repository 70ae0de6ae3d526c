"""Step functions and abstract input specs for the assigned input shapes.
PyTorch port of ``repro.launch.steps``.

Three step kinds, one per kind of input shape:
- train_step   : frozen-base tri-LoRA fine-tuning step (forward, adapter
                 gradients, AdamW) — ``train_4k``.
- prefill_step : full-sequence forward, last-position logits —
                 ``prefill_32k``.
- serve_step   : ONE new token against a KV cache of ``seq_len`` —
                 ``decode_32k``, ``long_500k``.

The steps run where their params lie (the card, unless the caller built
them on the CPU); a numpy batch is moved there.  The JAX package's
``make_fed_round_step`` (one federated client per pod of a device mesh)
and its pod-stacked helpers wait for the mesh port and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import layers, model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, apply_updates
from repro_torch.tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# the four assigned input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

SWA_VARIANT_WINDOW = 8192


def shape_variant(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """long_500k needs sub-quadratic attention: full-attention archs run
    their sliding-window variant (same weights, window=8192); natively
    sub-quadratic archs (ssm/hybrid/swa) are unchanged."""
    if shape_name == "long_500k" and "attn" in cfg.layer_pattern:
        pattern = tuple("swa" if k == "attn" else k for k in cfg.layer_pattern)
        return cfg.with_overrides(layer_pattern=pattern,
                                  window=cfg.window or SWA_VARIANT_WINDOW,
                                  name=cfg.name + "+swa")
    return cfg


def _f(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Stand-ins on the ``meta`` device for every model input (no
    allocation), with the JAX package's shapes and dtypes."""
    sh = SHAPES[shape_name]
    b, s = sh.global_batch, sh.seq_len
    i32 = torch.int32
    if sh.kind in ("train", "prefill"):
        batch = {"tokens": _f((b, s), i32)}
        if sh.kind == "train":
            batch["labels"] = _f((b, s), i32)
        if cfg.pos_type == "mrope":
            p = cfg.vision_patches
            batch["positions"] = _f((b, s + p, 3), i32)
            batch["vision"] = _f((b, p, cfg.d_model), cfg.dtype)
        else:
            batch["positions"] = _f((b, s), i32)
        if cfg.enc_dec:
            batch["frames"] = _f((b, cfg.enc_frames, cfg.d_model), cfg.dtype)
        return batch
    # decode: one token against a seq_len cache
    pos = _f((b, 1, 3), i32) if cfg.pos_type == "mrope" else _f((b, 1), i32)
    return {"token": _f((b, 1), i32), "positions": pos}


def abstract_cache(cfg: ModelConfig, shape_name: str) -> dict:
    """The decode cache of the shape's batch and ``seq_len``, on ``meta``."""
    sh = SHAPES[shape_name]
    return model.init_decode_cache(cfg, sh.global_batch, sh.seq_len,
                                   device="meta")


# ---------------------------------------------------------------------------
# step factories
# ---------------------------------------------------------------------------

def _on(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _device(params: dict) -> torch.device:
    return tree_leaves(params["base"])[0].device


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict, *,
                   attn_impl: str | None = None,
                   microbatches: int = 1) -> tuple:
    """(loss, metrics, grads) of the adapter at ``params`` on ``batch``.
    ``microbatches = k > 1`` is gradient accumulation as the JAX package's
    ``lax.scan`` does it: k sequential microbatches of B/k sequences, their
    gradients summed in f32 from zero and divided by k, loss and metrics
    averaged over the k."""
    adapter, base = params["adapter"], params["base"]

    def one(mb):
        ad = tree_map(lambda t: t.detach().requires_grad_(True), adapter)
        loss, metrics = model.loss_fn(cfg, ad, base, mb, attn_impl=attn_impl)
        grads = torch.autograd.grad(loss, tree_leaves(ad))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    batch = _on(batch, _device(params))
    if microbatches == 1:
        loss, metrics, grads = one(batch)
    else:
        k = microbatches
        parts = {key: x.reshape((k, x.shape[0] // k) + x.shape[1:])
                 for key, x in batch.items()}
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in tree_leaves(adapter)]
        loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
        ms = []
        for i in range(k):
            l, m, g = one({key: x[i] for key, x in parts.items()})
            acc = [a + gi for a, gi in zip(acc, g)]
            loss = loss + l
            ms.append(m)
        grads = [a / k for a in acc]
        loss = loss / k
        metrics = {key: torch.stack([m[key] for m in ms]).mean()
                   for key in ms[0]}
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), adapter)


def make_train_step(cfg: ModelConfig, lr: float = 1e-4,
                    attn_impl: str | None = None,
                    microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`loss_and_grads`, then AdamW on the adapter; the base
    is frozen.  ``train_step.optimizer`` makes the optimizer state.
    ``attn_impl=None`` defers to ``cfg.attn_impl``."""
    opt = adamw(lr=lr)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(
            cfg, params, batch, attn_impl=attn_impl,
            microbatches=microbatches)
        upd, opt_state2 = opt.update(grads, opt_state, params["adapter"])
        adapter = apply_updates(params["adapter"], upd)
        return ({"base": params["base"], "adapter": adapter}, opt_state2,
                {"loss": loss, **metrics})

    train_step.optimizer = opt
    return train_step


def make_prefill_step(cfg: ModelConfig,
                      attn_impl: str | None = None) -> Callable:
    """``prefill_step(params, batch) -> (B, padded vocab)`` f32 logits of
    the last position (pad logits -1e30)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            hidden, _, _ = model.forward_hidden(
                cfg, params["base"], params["adapter"],
                _on(batch, _device(params)), attn_impl=attn_impl)
            return layers.unembed(hidden[:, -1], params["base"]["embed"],
                                  cfg.vocab_size)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, batch) -> (logits (B, padded vocab),
    cache)``: one token through ``model.decode_step`` (the cache's K/V
    written in place)."""
    def serve_step(params, cache, batch):
        with torch.no_grad():
            logits, cache = model.decode_step(
                cfg, params["base"], params["adapter"], cache,
                _on(batch, _device(params)), pad_vocab=True)
        return logits[:, 0], cache
    return serve_step


# ---------------------------------------------------------------------------
# the federated round over a device mesh (not ported)
# ---------------------------------------------------------------------------

def _mesh_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP, Queue 1: 'launch/mesh.py'); "
        f"the port's federated rounds run in core.federated.run_federated "
        f"and launch.train.run")


def make_fed_round_step(cfg: ModelConfig, mesh=None, lr: float = 1e-4,
                        attn_impl: str | None = None,
                        payload_dtype=None) -> Callable:
    raise _mesh_not_ported("make_fed_round_step")


def pod_stacked_adapter(cfg: ModelConfig, n_pods: int):
    raise _mesh_not_ported("pod_stacked_adapter")


def pod_stacked_opt_state(cfg: ModelConfig, n_pods: int, opt=None):
    raise _mesh_not_ported("pod_stacked_opt_state")
