"""Federated fine-tuning strategies: CE-LoRA + the paper's six baselines.
PyTorch port of ``repro.core.baselines``.

Each strategy describes
- which adapter factors are trainable (``grad_mask``),
- what goes up the wire (uplink payload),
- how the server aggregates (fedavg / personalized / none),
- what comes back down and how it is installed,
- any extra local objective term (pFedMe's Moreau-envelope prox).

All strategies share the client state layout
``{'adapter': tri-LoRA tree, 'head': (D,K)}`` (plus method extras), so the
runner in :mod:`repro_torch.core.federated` is strategy-agnostic.

Every client-side method is tree algebra with no assumption on a leaf's
leading axes, so it runs unchanged on a STACKED state (every leaf with a
leading client axis m, :mod:`.client_batch`); the server's stacked form is
:meth:`Strategy.server_stacked`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import aggregation, client_batch, tri_lora
from repro_torch.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# tree helpers over adapter trees
# ---------------------------------------------------------------------------

def _select(adapter_tree: Any, keys: tuple[str, ...]) -> Any:
    """Sub-tree with only the chosen factors of each adapter."""
    return tree_map(lambda a: {k: a[k] for k in keys}, adapter_tree,
                    is_leaf=tri_lora.is_adapter)


def _install(adapter_tree: Any, sub: Any, keys: tuple[str, ...]) -> Any:
    return tree_map(lambda a, s: dict(a, **{k: s[k].to(a[k].dtype)
                                            for k in keys}),
                    adapter_tree, sub, is_leaf=tri_lora.is_adapter)


def adapter_grad_mask(adapter_tree: Any, train_keys: tuple[str, ...]) -> Any:
    """Per factor: True where it trains.  The runner takes gradients of the
    True factors only; a frozen factor's update is then exactly zero, as
    the JAX package's 0/1 gradient mask makes it."""
    return tree_map(lambda a: {k: k in train_keys for k in a},
                    adapter_tree, is_leaf=tri_lora.is_adapter)


# ---------------------------------------------------------------------------
# strategy definition
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Strategy:
    name: str
    train_keys: tuple[str, ...]              # trainable tri-LoRA factors
    uplink_keys: tuple[str, ...]             # factors sent to the server
    aggregate: str                           # 'none' | 'fedavg' | 'personalized'
    dual: bool = False                       # FDLoRA: extra global adapter
    prox: float = 0.0                        # pFedMe λ (0 = off)

    # ----------------------------------------------------------- client side
    def init_state(self, client: dict) -> dict:
        state = dict(client)
        if self.dual:
            # FDLoRA: second (global) adapter, same structure, zeros-B
            state["global_adapter"] = tree_map(
                lambda a: {"A": a["A"] * 0.7, "C": a["C"],
                           "B": torch.zeros_like(a["B"])},
                client["adapter"], is_leaf=tri_lora.is_adapter)
        if self.prox:
            state["w"] = _select(client["adapter"], self.uplink_keys)
        return state

    def trainable(self, state: dict) -> dict:
        t = {"adapter": state["adapter"], "head": state["head"]}
        if self.dual:
            t["global_adapter"] = state["global_adapter"]
        return t

    def grad_mask(self, trainable: dict) -> dict:
        m = {"adapter": adapter_grad_mask(trainable["adapter"],
                                          self.train_keys),
             "head": True}
        if self.dual:
            m["global_adapter"] = adapter_grad_mask(
                trainable["global_adapter"], ("A", "B"))
        return m

    def effective_adapter(self, trainable: dict) -> Any:
        if self.dual:
            return tri_lora.tree_combine(trainable["global_adapter"],
                                         trainable["adapter"])
        return trainable["adapter"]

    def local_penalty(self, trainable: dict, state: dict,
                      stacked: bool = False) -> torch.Tensor:
        """pFedMe's prox term; with ``stacked`` (leaves (m, …)) an (m,)
        vector of each client's own term."""
        theta = _select(trainable["adapter"], self.uplink_keys)
        lead = 1 if stacked else 0

        def sq(a, b):
            d = torch.square(a.float() - b.float())
            return d.reshape(d.shape[:lead] + (-1,)).sum(-1)
        diffs = [sq(a, b) for a, b in zip(tree_leaves(theta),
                                          tree_leaves(state["w"]))]
        return 0.5 * self.prox * sum(diffs)

    def after_local(self, state: dict, eta: float = 0.5) -> dict:
        """pFedMe outer update: move the local copy of the global point
        toward the personalized optimum θ."""
        if not self.prox:
            return state
        theta = _select(state["adapter"], self.uplink_keys)
        w = tree_map(lambda wv, tv: wv - eta * (wv - tv), state["w"], theta)
        return dict(state, w=w)

    # ------------------------------------------------------------- transport
    def uplink(self, state: dict) -> Optional[Any]:
        if self.aggregate == "none":
            return None
        src = state["global_adapter"] if self.dual else (
            state["w"] if self.prox else state["adapter"])
        if self.prox:
            return src  # already the selected sub-tree
        return _select(src, self.uplink_keys)

    def server(self, payloads: list, *, sample_counts, weights=None,
               participants=None) -> list:
        """Per-client downlinks.  ``payloads`` covers all m clients
        (absentees contribute their last-uploaded payload, which the masks
        zero out); ``participants`` is an optional boolean (m,) mask of the
        clients that completed the round."""
        if self.aggregate == "none":
            return [None] * len(payloads)
        if self.aggregate == "fedavg":
            g = aggregation.fedavg(payloads, sample_counts, participants)
            return [g] * len(payloads)
        if weights is None:
            raise ValueError(f"personalized aggregation needs weights; "
                             f"strategy {self.name!r} got weights=None")
        return aggregation.aggregate_payloads(payloads, weights)

    def server_stacked(self, payload: Any, *, sample_counts, weights=None,
                       participants=None, col_scale=None) -> Optional[Any]:
        """Stacked form of :meth:`server`: ``payload`` is ONE tree with a
        leading client axis (m, …); returns a stacked downlink of the same
        layout (a FedAvg result broadcast over the client axis), or None
        when the strategy never communicates.  ``participants`` masks the
        aggregation as in :meth:`server`; the caller installs the downlink
        into the participants only (``client_batch.select_clients``).
        ``col_scale`` is the async engine's per-contributor staleness
        discount: it reaches FedAvg directly, while the personalized path
        bakes it into ``weights`` upstream."""
        if self.aggregate == "none":
            return None
        m = len(sample_counts)
        if self.aggregate == "fedavg":
            g = aggregation.fedavg_stacked(payload, sample_counts,
                                           participants, col_scale=col_scale)
            return client_batch.broadcast_to_clients(g, m)
        if weights is None:
            raise ValueError(f"personalized aggregation needs weights; "
                             f"strategy {self.name!r} got weights=None")
        return aggregation.aggregate_stacked(payload, weights)

    def install(self, state: dict, downlink: Any) -> dict:
        if downlink is None:
            return state
        state = dict(state)
        if self.dual:
            state["global_adapter"] = _install(state["global_adapter"],
                                               downlink, self.uplink_keys)
        elif self.prox:
            state["w"] = downlink
            # personalized θ keeps its value (pFedMe); only w is replaced
        else:
            state["adapter"] = _install(state["adapter"], downlink,
                                        self.uplink_keys)
        return state


# ---------------------------------------------------------------------------
# registry — the paper's §IV-A baseline list
# ---------------------------------------------------------------------------

STRATEGIES: dict[str, Strategy] = {
    # (1) LoRA with local data only — vanilla LoRA (C pinned at identity)
    "lora_loc": Strategy("lora_loc", ("A", "B"), (), "none"),
    # (2) FedPETuning — FedAvg over the full (A, B)
    "fedpetuning": Strategy("fedpetuning", ("A", "B"), ("A", "B"), "fedavg"),
    # (3) FFA-LoRA — freeze A, transmit/average B only
    "ffa_lora": Strategy("ffa_lora", ("B",), ("B",), "fedavg"),
    # (4) FDLoRA — dual LoRA: fedavg'd global module + local module
    "fdlora": Strategy("fdlora", ("A", "B"), ("A", "B"), "fedavg", dual=True),
    # (5) pFedMe with full LoRA aggregation
    "pfedme_lora": Strategy("pfedme_lora", ("A", "B"), ("A", "B"), "fedavg",
                            prox=1.0),
    # (6) pFedMe with FFA-LoRA's communication (B only)
    "pfedme_ffa": Strategy("pfedme_ffa", ("B",), ("B",), "fedavg", prox=1.0),
    # OURS: tri-factor, transmit C only, personalized aggregation
    "celora": Strategy("celora", ("A", "B", "C"), ("C",), "personalized"),
    # ablation: tri-factor + plain FedAvg (paper Tables IV/V row 2)
    "celora_fedavg": Strategy("celora_fedavg", ("A", "B", "C"), ("C",),
                              "fedavg"),
}


def get_strategy(name: str) -> Strategy:
    if name not in STRATEGIES:
        raise KeyError(f"unknown method {name!r}; known: {sorted(STRATEGIES)}")
    return STRATEGIES[name]
