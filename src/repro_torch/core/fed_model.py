"""Federated fine-tuning task: frozen backbone + tri-LoRA + local head.
PyTorch port of ``repro.core.fed_model``.

A "pre-trained" transformer backbone (optionally warmed up on IID data,
then frozen) with per-client trainable (adapter, classifier head).  LoRA
adapts the attention projections; the head is always local (never
transmitted) for every method.  Random draws come from explicit
``torch.Generator``s, on the generator's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import model, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, apply_updates
from repro_torch.tree import tree_leaves, tree_map


class FedTask(NamedTuple):
    cfg: ModelConfig
    base: dict             # frozen backbone params
    n_classes: int

    # ------------------------------------------------------------------ init
    @staticmethod
    def create(generator: torch.Generator, cfg: ModelConfig, n_classes: int,
               pretrain_batches=None, pretrain_lr: float = 1e-3
               ) -> "FedTask":
        params = model.init_params(cfg, generator)
        base = params["base"]
        if pretrain_batches is not None:
            base = _pretrain(cfg, params, pretrain_batches, pretrain_lr,
                             n_classes)
        return FedTask(cfg, base, n_classes)

    def init_client(self, generator: torch.Generator) -> dict:
        """A fresh client: tri-LoRA adapters (A ~ N(0, 1/r), C = I, B = 0)
        and a N(0, 0.02²) head, drawn from ``generator``."""
        ag, at = transformer.init_stack_adapters(generator, self.cfg)
        head = torch.randn((self.cfg.d_model, self.n_classes),
                           generator=generator, device=generator.device,
                           dtype=torch.float32) * 0.02
        return {"adapter": {"groups": ag, "tail": at}, "head": head}

    # --------------------------------------------------------------- forward
    def logits(self, adapter: dict, head: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
        """(B, C) logits of tokens (B, T) for one client, or — vectorized
        clients, as ``jax.vmap`` over them — (m, B, C) of tokens (m, B, T)
        for a stacked client state (adapter leaves (m, …), head (m, D, C)):
        the m batches fold into one of m·B sequences, each applying its
        client's adapter (``forward_hidden``'s ``adapter_rows``), and the
        pooled (m, B, D) features meet the heads in one batched product."""
        # attn_impl rides on cfg, so every client trains through the
        # configured backend — flash included
        stacked = tokens.dim() == 3
        rows = (model.client_rows(tokens.shape[0], tokens.shape[1],
                                  tokens.device) if stacked else None)
        hidden, _, _ = model.forward_hidden(
            self.cfg, self.base, adapter,
            {"tokens": tokens.reshape(-1, tokens.shape[-1])},
            attn_impl=self.cfg.attn_impl, adapter_rows=rows)
        pooled = hidden.float().mean(dim=1)
        if stacked:
            return torch.bmm(pooled.reshape(*tokens.shape[:2], -1), head)
        return pooled @ head

    def loss(self, trainable: dict, tokens: torch.Tensor,
             labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean NLL, accuracy) over one client's batch; for a stacked
        state and (m, B, T) tokens, (m,) vectors of each client's own.
        Differentiate their SUM: each client's leaves then get exactly
        their own gradient."""
        logits = self.logits(trainable["adapter"], trainable["head"], tokens)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        acc = (torch.argmax(logits, -1) == labels).float()
        return nll.mean(-1), acc.mean(-1)

    def features(self, tokens: torch.Tensor) -> torch.Tensor:
        """Frozen-backbone features for the GMM data similarity: the mean
        final hidden state, run with no adapter (the JAX package runs a
        fresh adapter with B = 0, whose delta is exactly zero)."""
        hidden, _, _ = model.forward_hidden(
            self.cfg, self.base, model.no_adapter(self.cfg),
            {"tokens": tokens}, attn_impl=self.cfg.attn_impl)
        return hidden.float().mean(dim=1)


def _pretrain(cfg: ModelConfig, params: dict, batches, lr: float,
              n_classes: int) -> dict:
    """Brief full-parameter warm-up on IID data; the result is the frozen
    'pre-trained foundation model' the federated phase adapts."""
    dev = tree_leaves(params["base"])[0].device
    train = {"base": params["base"],
             "head": torch.zeros((cfg.d_model, n_classes),
                                 dtype=torch.float32, device=dev)}
    adapter = params["adapter"]
    opt = adamw(lr=lr)
    state = opt.init(train)
    for b in batches:
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), train)
        tokens = torch.as_tensor(b["tokens"], device=dev)
        labels = torch.as_tensor(b["labels"], device=dev).long()
        hidden, _, _ = model.forward_hidden(cfg, leaves["base"], adapter,
                                            {"tokens": tokens})
        logits = hidden.float().mean(dim=1) @ leaves["head"]
        loss = -torch.gather(torch.log_softmax(logits, -1), 1,
                             labels[:, None]).mean()
        flat = tree_leaves(leaves)
        grads = dict(zip(map(id, flat), torch.autograd.grad(
            loss, flat, allow_unused=True)))
        upd, state = opt.update(tree_map(lambda t: grads[id(t)], leaves),
                                state, train)
        train = apply_updates(train, upd)
    return tree_map(lambda t: t.detach(), train["base"])
