"""DLG-style gradient-inversion attack harness (paper §IV-C, Fig. 5).
PyTorch port of ``repro.core.privacy``.

The attacker observes the gradients of the TRANSMITTED parameters for one
private batch and optimizes a dummy input (a soft bag-of-tokens) and dummy
soft labels until their gradients match (Zhu et al., Deep Leakage from
Gradients).  Recovery is scored as precision / recall / F1 of the
reconstructed token sets.

What each method exposes per round:
- full fine-tune : grads of the dense W          (d×d)      — most leakage
- FedPETuning    : grads of A (d×r) and B (r×k)
- FFA-LoRA       : grads of B only               (r×k)
- CE-LoRA        : grads of C only               (r×r)      — least leakage

The surrogate model is a frozen-embedding bag-of-tokens classifier with a
tri-LoRA-adapted projection.  The attack differentiates through the
observed gradients (a double backward), so the model is plain tensor
algebra: its projection never goes through ``layers.dense``, whose CUDA
kernels have no second derivative.  Random draws come from a
``torch.Generator`` on the run's device; a caller that holds other draws
(the JAX package's) builds :class:`DLGModel` from them
(``repro_torch.convert.dlg_model_from_numpy``) and passes the dummy
initialization to :func:`dlg_attack`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import tri_lora
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, apply_updates


@dataclasses.dataclass
class DLGModel:
    embed: torch.Tensor   # (V, d) frozen
    w: torch.Tensor       # (d, d) frozen base projection
    head: torch.Tensor    # (d, K) frozen
    adapter: dict         # tri-LoRA {'A','C','B'}
    scaling: float = 2.0

    def logits(self, bag: torch.Tensor, adapter=None) -> torch.Tensor:
        """bag: (B, V) normalized token counts."""
        a = adapter if adapter is not None else self.adapter
        h = bag @ self.embed
        h = h @ self.w + self.scaling * ((h @ a["A"]) @ a["C"]) @ a["B"]
        return torch.tanh(h) @ self.head

    def loss(self, bag, labels, adapter=None):
        lp = torch.log_softmax(self.logits(bag, adapter), -1)
        return -torch.mean(torch.sum(labels * lp, dim=-1))


def make_model(generator: torch.Generator, vocab: int = 128, d: int = 32,
               n_classes: int = 4, rank: int = 4) -> DLGModel:
    """A random surrogate on the generator's device: the frozen base
    (embed, w, head) and a mid-training adapter (B ≠ 0, C perturbed), each
    an independent draw of the generator's stream."""
    dev = generator.device

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev)

    adapter = tri_lora.init_adapter(generator, d, d, rank)
    adapter["B"] = normal(adapter["B"].shape) * 0.3
    adapter["C"] = adapter["C"] + normal(adapter["C"].shape) * 0.2
    return DLGModel(embed=normal((vocab, d)) * 0.5,
                    w=normal((d, d)) * 0.3,
                    head=normal((d, n_classes)) * 0.5, adapter=adapter)


PAYLOADS = {
    "full_ft": ("w",),
    "fedpetuning": ("A", "B"),
    "ffa_lora": ("B",),
    "celora": ("C",),
}


def observed_grads(model: DLGModel, payload: Sequence[str],
                   bag: torch.Tensor, labels: torch.Tensor, *,
                   create_graph: bool = False) -> dict:
    """Client-side: gradients of exactly the transmitted parameters, keyed
    by name.  ``create_graph`` keeps them differentiable in ``bag`` and
    ``labels`` (the attacker's gradient matching)."""
    parts = {k: (model.w if k == "w" else model.adapter[k]).detach()
             .requires_grad_(True) for k in sorted(payload)}
    adapter = dict(model.adapter)
    adapter.update({k: v for k, v in parts.items() if k != "w"})
    m2 = dataclasses.replace(model, w=parts.get("w", model.w),
                             adapter=adapter)
    with torch.enable_grad():
        grads = torch.autograd.grad(m2.loss(bag, labels),
                                    list(parts.values()),
                                    create_graph=create_graph)
    return dict(zip(parts, grads))


def dlg_attack(model: DLGModel, payload: Sequence[str], g_obs: dict,
               batch: int, generator: Optional[torch.Generator] = None,
               n_steps: int = 400, lr: float = 0.1, *,
               dummy: Optional[dict] = None) -> torch.Tensor:
    """Attacker-side gradient matching; returns the recovered soft bag
    (B, V).  The dummy input and labels start at 0.1·N(0, 1) drawn from
    ``generator``, or at ``dummy`` ({'x': (B, V), 'y': (B, K)})."""
    vocab, n_classes = model.embed.shape[0], model.head.shape[1]
    dev = model.embed.device
    if dummy is None:
        dummy = {"x": torch.randn((batch, vocab), generator=generator,
                                  device=dev) * 0.1,
                 "y": torch.randn((batch, n_classes), generator=generator,
                                  device=dev) * 0.1}
    dummy = {k: v.to(dev) for k, v in dummy.items()}
    obs = [g_obs[k] for k in sorted(g_obs)]
    opt = adamw(lr=lr)
    state = opt.init(dummy)

    def match_loss(dmy):
        bag = torch.softmax(dmy["x"], -1)
        lab = torch.softmax(dmy["y"], -1)
        g = observed_grads(model, payload, bag, lab, create_graph=True)
        g = [g[k] for k in sorted(g)]
        num = sum(torch.sum(ga * gb) for ga, gb in zip(g, obs))
        na = torch.sqrt(sum(torch.sum(x * x) for x in g))
        nb = torch.sqrt(sum(torch.sum(x * x) for x in obs))
        cos = num / torch.clamp(na * nb, min=1e-12)
        l2 = sum(torch.sum((ga - gb) ** 2) for ga, gb in zip(g, obs))
        return l2 - 0.1 * cos

    for _ in range(n_steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in dummy.items()}
        with torch.enable_grad():
            grads = torch.autograd.grad(match_loss(leaves),
                                        list(leaves.values()))
        upd, state = opt.update(dict(zip(leaves, grads)), state, dummy)
        dummy = apply_updates(dummy, upd)
    return torch.softmax(dummy["x"], -1)


def token_recovery_metrics(true_bag: np.ndarray, rec_bag: np.ndarray,
                           top_k: int | None = None) -> dict:
    """Precision / recall / F1 of recovered token sets (per sample, avgd)."""
    b = true_bag.shape[0]
    precs, recs = [], []
    for i in range(b):
        true_set = set(np.nonzero(true_bag[i] > 1e-6)[0].tolist())
        k = top_k or len(true_set)
        rec_set = set(np.argsort(rec_bag[i])[::-1][:k].tolist())
        inter = len(true_set & rec_set)
        precs.append(inter / max(len(rec_set), 1))
        recs.append(inter / max(len(true_set), 1))
    p, r = float(np.mean(precs)), float(np.mean(recs))
    f1 = 2 * p * r / max(p + r, 1e-12)
    return {"precision": p, "recall": r, "f1": f1}


def private_batch(seed: int, batch: int, n_tokens: int, vocab: int,
                  n_classes: int = 4) -> tuple:
    """(true bag (B, V), one-hot labels (B, K)) as numpy f32: the JAX
    package's numpy stream of ``run_dlg_experiment``, bit for bit."""
    rng = np.random.default_rng(seed)
    true = np.zeros((batch, vocab), np.float32)
    for i in range(batch):
        toks = rng.choice(vocab, n_tokens, replace=False)
        true[i, toks] = 1.0 / n_tokens
    labels = np.eye(n_classes, dtype=np.float32)[
        rng.integers(0, n_classes, batch)]
    return true, labels


def run_dlg_experiment(seed: int = 0, batch: int = 4, n_tokens: int = 6,
                       vocab: int = 128, n_steps: int = 400, *,
                       device="cuda", model: Optional[DLGModel] = None,
                       dummy: Optional[dict] = None) -> dict:
    """Full Fig-5 experiment: attack every method's payload, report
    precision / recall / F1 per method.  The model is ``make_model`` from a
    generator seeded ``seed`` (or ``model``); every method's attack starts
    from the same dummy, drawn from a generator seeded ``seed + 7`` (or
    ``dummy``)."""
    dev = resolve_device(device)
    if model is None:
        model = make_model(torch.Generator(device=dev).manual_seed(seed),
                           vocab=vocab)
    true, labels = private_batch(seed, batch, n_tokens, vocab)
    bag = torch.as_tensor(true, device=dev)
    lab = torch.as_tensor(labels, device=dev)
    out = {}
    for method, payload in PAYLOADS.items():
        g_obs = observed_grads(model, payload, bag, lab)
        rec = dlg_attack(model, payload, g_obs, batch,
                         torch.Generator(device=dev).manual_seed(seed + 7),
                         n_steps=n_steps, dummy=dummy)
        out[method] = token_recovery_metrics(true, rec.cpu().numpy())
    return out
