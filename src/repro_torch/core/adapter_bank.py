"""Stacked tri-LoRA adapter bank for multi-tenant personalized serving.

PyTorch port of ``repro.core.adapter_bank``.  CE-LoRA's personalized
aggregation leaves ONE tri-factorized (A, C, B) adapter per client (paper
eqn. 3/10), stacked on a leading (m, …) client axis.  :class:`AdapterBank`
holds that stack plus the user → row map and the three views serving needs:
``row(i)``, ``decode_tree()`` and ``merged_base()``.  :func:`export_bank`
reads that stack from a federated checkpoint (the port's or the JAX
package's: every engine and client store writes it under
``state/adapter``) and nothing else of it — not the error-feedback carry,
the optimizer state or the uplink codec.  :func:`random_bank` draws a
synthetic bank with distinct non-zero deltas.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import tri_lora
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map


def _normalize_tail(tree: dict) -> dict:
    """``ckpt.load_subtree`` rebuilds tuple indices as string dict keys;
    decode consumes the tail as a tuple again."""
    out = dict(tree)
    tail = tree.get("tail", {})
    if isinstance(tail, dict):
        out["tail"] = tuple(tail[k] for k in sorted(tail, key=int))
    if "groups" not in out:
        out["groups"] = None
    return out


def _adapter_leaves(tree) -> list:
    return [a for a in tree_leaves(tree, is_leaf=tri_lora.is_adapter)
            if tri_lora.is_adapter(a)]


@dataclasses.dataclass
class AdapterBank:
    """A stacked (m, …) tri-LoRA adapter tree plus the user → row map.

    ``tree`` mirrors the model's adapter structure ({'groups', 'tail'}) with
    every {A, C, B} leaf carrying a leading client axis: groups leaves are
    (m, q, …), tail leaves (m, …).
    """

    tree: dict
    n_clients: int
    rank: int
    users: Dict[str, int]

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.tree)[0].device

    def lookup(self, user_id: str) -> int:
        """Bank row serving this user; unknown users fail loudly."""
        try:
            return self.users[user_id]
        except KeyError:
            raise KeyError(
                f"user {user_id!r} has no adapter bank row (known: "
                f"{sorted(self.users)[:8]}…)") from None

    def rows(self, user_ids: Sequence[Optional[str]]) -> torch.Tensor:
        """(B,) int32 row indices on the bank's device; ``None`` entries
        (empty batch slots) become -1, the masked-row sentinel."""
        return torch.tensor([-1 if u is None else self.lookup(u)
                             for u in user_ids], dtype=torch.int32,
                            device=self.device)

    def row(self, i: int) -> dict:
        """One client's adapter tree — what ``model.decode_step`` takes as
        ``adapter`` (groups leaves (q, …), tail a tuple)."""
        if not 0 <= i < self.n_clients:
            raise IndexError(f"bank row {i} out of range "
                             f"[0, {self.n_clients})")
        return tree_map(lambda x: x[i], self.tree)

    def decode_tree(self) -> dict:
        """Bank view for batched decode: the layer-group axis LEADS, so
        groups leaves become (q, m, …), made contiguous once so every
        per-layer slice is a contiguous (m, …) bank; tail leaves stay."""
        groups = self.tree.get("groups")
        return {"groups": None if groups is None else tree_map(
                    lambda x: x.transpose(0, 1).contiguous(), groups),
                "tail": self.tree["tail"]}

    def merged_base(self, base: dict, i: int, scaling: float) -> dict:
        """Paper eqn. 10: W_i = W + s·A_i·C_i·B_i folded into the base
        params — the naive per-user serving baseline.  Every adapted weight
        is merged, an encoder-decoder block's ``xattn`` ones too, as in the
        JAX package."""
        row = self.row(i)

        def _merge(b, a):
            if a is None:
                return b
            if tri_lora.is_adapter(a):
                return tri_lora.merge(b, a, scaling)
            if isinstance(a, dict):
                return {k: (_merge(b[k], a[k]) if k in a else b[k])
                        for k in b}
            return tuple(_merge(bb, aa) for bb, aa in zip(b, a))

        out = dict(base)
        if base.get("groups") is not None and row.get("groups") is not None:
            out["groups"] = _merge(base["groups"], row["groups"])
        out["tail"] = _merge(base["tail"], row["tail"])
        return out


def _validate(tree: dict, n_clients: int, path: str) -> int:
    leaves = _adapter_leaves(tree)
    if not leaves:
        raise ValueError(
            f"checkpoint {path!r} stores no tri-LoRA {{A,B,C}} nodes under "
            f"state/adapter — not a federated fine-tuning checkpoint")
    ranks = set()
    for ad in leaves:
        for k in ("A", "B", "C"):
            if ad[k].shape[0] != n_clients:
                raise ValueError(
                    f"checkpoint {path!r}: adapter leaf {k} has leading dim "
                    f"{ad[k].shape[0]} but metadata says n_clients="
                    f"{n_clients} — stacked client axis mismatch")
        ranks.add(int(ad["C"].shape[-1]))
    if len(ranks) != 1:
        raise ValueError(f"checkpoint {path!r}: inconsistent tri-LoRA ranks "
                         f"{sorted(ranks)} across adapter leaves")
    return ranks.pop()


def export_bank(path: str, user_ids: Optional[Sequence[str]] = None, *,
                device="cuda") -> AdapterBank:
    """Export the stacked adapter bank of a federated checkpoint onto
    ``device``.

    Reads only ``state/adapter`` (stacked (m, …) on the client axis, the
    same subtree from every engine and client store of either package)
    and the ``n_clients`` metadata.  A checkpoint without that metadata,
    without adapter leaves, or whose stacked client axis contradicts
    ``n_clients`` raises ``ValueError``.  ``user_ids`` maps request
    identities to bank rows positionally (default ``client-0 …
    client-{m-1}``)."""
    dev = resolve_device(device)
    meta = ckpt.metadata(path)
    if "n_clients" not in meta:
        raise ValueError(
            f"checkpoint {path!r} has no 'n_clients' in its metadata — not "
            f"a federated checkpoint (or written before the adapter-bank "
            f"layout, DESIGN.md §15); cannot export an adapter bank")
    m = int(meta["n_clients"])
    sub = ckpt.load_subtree(path, "state/adapter")
    if not sub:
        raise ValueError(
            f"checkpoint {path!r} stores nothing under state/adapter — "
            f"cannot export an adapter bank")
    tree = _normalize_tail(sub)
    rank = _validate(tree, m, path)
    if user_ids is None:
        user_ids = [f"client-{i}" for i in range(m)]
    if len(user_ids) != m:
        raise ValueError(f"{len(user_ids)} user_ids for {m} bank rows")
    return AdapterBank(tree=tree_map(lambda t: t.to(dev), tree),
                       n_clients=m, rank=rank,
                       users={u: i for i, u in enumerate(user_ids)})


def random_bank(cfg, m: int, generator: torch.Generator,
                user_ids: Optional[Sequence[str]] = None) -> AdapterBank:
    """Synthetic m-row bank with DISTINCT non-zero deltas per client, drawn
    in f32 on the generator's device.

    Freshly initialized tri-LoRA adapters are exact no-ops (B = 0), so a
    bank of them cannot tell correct heterogeneous routing from ignoring
    the adapters; here B is random and C a perturbed identity.
    """
    from repro_torch.models import transformer

    q, pattern, rem = cfg.stack_plan()
    dev = generator.device
    r = cfg.lora_rank

    def randn(shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32)

    def bank_leaf(lead, din, dout):
        return {"A": randn((m,) + lead + (din, r)) / math.sqrt(r),
                "C": torch.eye(r, device=dev) + 0.1 * randn((m,) + lead
                                                            + (r, r)),
                "B": 0.02 * randn((m,) + lead + (r, dout))}

    def block(lead, kind):
        return {mod: {t: bank_leaf(lead, din, dout)
                      for t, (din, dout) in ts.items()}
                for mod, ts in transformer._adapter_shapes(
                    cfg, kind, cross=cfg.enc_dec).items()}

    tree = {"groups": ({str(i): block((q,), kind)
                        for i, kind in enumerate(pattern)} if q else None),
            "tail": tuple(block((), kind) for kind in rem)}
    if user_ids is None:
        user_ids = [f"client-{i}" for i in range(m)]
    return AdapterBank(tree=tree, n_clients=m, rank=r,
                       users={u: i for i, u in enumerate(user_ids)})
