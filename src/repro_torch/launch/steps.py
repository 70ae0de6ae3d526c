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
them on the CPU); a numpy batch is moved there.  ``make_fed_round_step``
is one federated micro-round with one client per pod of a mesh, and the
``pod_stacked_*`` helpers give its inputs on ``meta``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import tri_lora
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
# the federated round step over the pod axis (the paper's comm pattern)
# ---------------------------------------------------------------------------

def make_fed_round_step(cfg: ModelConfig, mesh, lr: float = 1e-4,
                        attn_impl: str | None = None,
                        payload_dtype=None) -> Callable:
    """One federated "micro-round" with each pod of ``mesh`` one client
    (``n_pods = mesh.shape["pod"]``): ``fed_round_step(params, adapter_p,
    opt_state_p, batch, agg_w) -> (adapter_p, opt_state_p, losses (n_pods,))``.

    ``adapter_p`` / ``opt_state_p`` carry a leading pod dim (an
    ``adamw(stacked=True)`` state).  The global batch splits into n_pods
    blocks of B/n_pods sequences, pod i's block applying pod i's adapter
    (``adapter_rows``: one grouped tri-LoRA launch per projection for all
    pods on the card); one AdamW step each, on the SUM of the per-pod
    losses, so A / B / the optimizer state stay pod-local.  The only
    cross-pod term is the personalized combination of the r×r C matrices
    (paper Alg. 1 lines 4–9): C̄_i = Σ_j W[i,j]·C_j, an f32 einsum over the
    pod axis, the C payload cast to ``payload_dtype`` first when one is
    given (the JAX package's all-gathered bf16 wire payload)."""
    opt = adamw(lr=lr, stacked=True)
    n_pods = mesh.shape["pod"]

    def fed_round_step(params, adapter_p, opt_state_p, batch, agg_w):
        base = params["base"]
        dev = _device(params)
        batch = _on(batch, dev)
        rows = model.client_rows(n_pods, batch["tokens"].shape[0] // n_pods,
                                 dev)
        ad = tree_map(lambda t: t.detach().requires_grad_(True), adapter_p)
        losses, _ = model.loss_fn(cfg, ad, base, batch, attn_impl=attn_impl,
                                  adapter_rows=rows)
        leaves = tree_leaves(ad)
        grads = iter(torch.autograd.grad(losses.sum(), leaves))
        upd, opt_state_p = opt.update(tree_map(lambda _: next(grads), ad),
                                      opt_state_p, adapter_p)
        adapter_p = apply_updates(adapter_p, upd)

        # ---- the ONLY cross-pod communication: the C matrices
        c_all = tri_lora.tree_payload(adapter_p)     # leaves (n_pods, …, r, r)
        if payload_dtype is not None:
            c_all = tree_map(lambda c: c.to(payload_dtype), c_all)
        w = torch.as_tensor(agg_w, dtype=torch.float32, device=dev)
        c_bar = tree_map(lambda c: torch.einsum("ij,j...->i...", w,
                                                c.float()), c_all)
        return (tri_lora.tree_load_payload(adapter_p, c_bar), opt_state_p,
                losses.detach())

    fed_round_step.optimizer = opt
    fed_round_step.n_pods = n_pods
    return fed_round_step


# ---------------------------------------------------------------------------
# pod-stacked stand-ins for the federated step's inputs
# ---------------------------------------------------------------------------

def _pod_stacked(tree, n_pods: int):
    return tree_map(lambda t: _f((n_pods,) + tuple(t.shape), t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def pod_stacked_adapter(cfg: ModelConfig, n_pods: int) -> dict:
    """The adapter on ``meta`` with a leading pod dim (one tri-LoRA set
    per pod)."""
    return _pod_stacked(model.abstract_params(cfg)["adapter"], n_pods)


def pod_stacked_opt_state(cfg: ModelConfig, n_pods: int, opt) -> dict:
    """``opt``'s state for :func:`pod_stacked_adapter`, on ``meta``."""
    return _pod_stacked(opt.init(model.abstract_params(cfg)["adapter"]),
                        n_pods)
