"""Sharding rules: PyTorch port of ``repro.launch.sharding``.

Path- and shape-driven partition specs for params (FSDP over ``data`` ×
tensor parallelism over ``model``), adapters, caches and batches, rule for
rule as in the JAX package (DESIGN.md §5):

- frozen base weights shard both ways: in-dim → ``data`` (FSDP), out-dim →
  ``model``; the out-projections (``wo``, ``w_down``, ``w_out``, the
  channel-mix ``wv``) transpose that;
- embeddings (V, D): V → ``model``, D → ``data``;
- MoE experts: expert axis → ``model`` when it divides, else tensor
  parallel inside each expert;
- tri-LoRA: A in-dim → ``data``, B out-dim → ``model``, C REPLICATED (the
  federated payload, so the cross-pod traffic is exactly the r² floats);
- KV caches: batch → ``data`` (+ ``pod``), cache sequence → ``model``;
- every rule falls back to replication where the dim does not divide.

A spec is a :class:`.mesh.PartitionSpec`: a tuple with one entry per tensor
dim, an axis name, a tuple of names, or ``None``.  :func:`to_placements`
turns one into the ``torch.distributed.tensor`` placements per mesh axis
(``Shard(dim)`` / ``Replicate()``), which need no process group.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.launch.mesh import Mesh, PartitionSpec as P
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map, tree_map_with_path

# parameter names whose matrix maps "wide → d_model" (shard in-dim on model)
_OUT_NAMES = {"wo", "w_down", "w_out"}
# 1-D biases on output features
_OUT_BIAS = {"bq", "bk", "bv", "conv_b", "b_a", "b_x"}


def _axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.axis_names else 1


def _fits(dim: int, mesh: Mesh, axis: str | None):
    if axis is None or axis not in mesh.axis_names:
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def _mat_spec(shape, mesh: Mesh, in_axis, out_axis) -> tuple:
    """Trailing-2D matrix spec with any number of leading (stack) dims."""
    lead = (None,) * (len(shape) - 2)
    return P(*lead, _fits(shape[-2], mesh, in_axis),
             _fits(shape[-1], mesh, out_axis))


def _is_moe_leaf(path_names, cfg: ModelConfig) -> bool:
    return cfg.is_moe and "moe" in path_names


def param_spec(path_names: tuple, shape: tuple, mesh: Mesh,
               cfg: ModelConfig, *, fsdp: bool = True) -> tuple:
    name = path_names[-1]
    parent = path_names[-2] if len(path_names) >= 2 else ""
    da = "data" if fsdp else None   # serving layout: no FSDP weight gathers

    # ---- tri-LoRA adapter factors (A/B/C names are adapter-exclusive)
    if name == "A":
        return _mat_spec(shape, mesh, da, None)
    if name == "B":
        return _mat_spec(shape, mesh, None, "model")
    if name == "C":
        return P(*(None,) * len(shape))         # replicated: the payload

    # ---- embeddings
    if name == "embed":
        return P(_fits(shape[0], mesh, "model"), _fits(shape[1], mesh, da))
    if name == "pos_embed":
        return P(None, _fits(shape[1], mesh, "model"))

    # ---- MoE
    if name == "router":
        return _mat_spec(shape, mesh, da, None)
    if parent == "moe" or (len(shape) >= 3 and name in
                           {"w_gate", "w_up", "w_in", "w_down", "w_out"}
                           and _is_moe_leaf(path_names, cfg)):
        # (…, E, d, f) expert tensors
        if _fits(shape[-3], mesh, "model"):
            lead = (None,) * (len(shape) - 3)
            return P(*lead, "model", _fits(shape[-2], mesh, da), None)
        if name in _OUT_NAMES:
            return _mat_spec(shape, mesh, "model", da)
        return _mat_spec(shape, mesh, da, "model")

    # ---- scalars / vectors
    if len(shape) <= 1:
        if name in _OUT_BIAS and shape:
            return P(_fits(shape[0], mesh, "model"))
        if name == "lam" and shape:
            return P(_fits(shape[0], mesh, "model"))
        return P(*(None,) * len(shape))

    # ---- channel-mix wv is (f, d): an out-projection despite the name
    if name == "wv" and parent == "cm":
        return _mat_spec(shape, mesh, "model", da)
    if name in _OUT_NAMES:
        return _mat_spec(shape, mesh, "model", da)
    # rwkv ddlerp low-rank: (d, 5, L) / (5, L, d) — tiny, shard the d side
    if name == "mix_a":
        return P(*(None,) * (len(shape) - 3), _fits(shape[-3], mesh, da),
                 None, None)
    if name == "mix_b":
        return P(*(None,) * (len(shape) - 1),
                 _fits(shape[-1], mesh, "model"))
    if name == "conv_w":
        return _mat_spec(shape, mesh, None, "model")
    # default in→out matrices (wq/wk/wv/wg/wr/w_a/w_x/w_b/mlp in/gate/up)
    return _mat_spec(shape, mesh, da, "model")


# ---------------------------------------------------------------------------
# tree-level builders
# ---------------------------------------------------------------------------

def _names(path: tuple) -> tuple:
    return tuple(str(p) for p in path)


def param_specs(tree: Any, mesh: Mesh, cfg: ModelConfig, *,
                fsdp: bool = True) -> Any:
    """The spec tree of a params / adapter / optimizer-state tree (tensors
    on any device, ``meta`` included); non-tensor leaves (the optimizer's
    step count) stay as they are.  ``fsdp=False`` is the serving layout:
    weights replicated over ``data``, tensor parallel over ``model``."""
    def spec(path, leaf):
        if not hasattr(leaf, "shape"):
            return leaf
        return param_spec(_names(path), tuple(leaf.shape), mesh, cfg,
                          fsdp=fsdp)
    return tree_map_with_path(spec, tree)


_CACHE_RANKS = {"k": 4, "v": 4, "xk": 4, "xv": 4, "wkv": 4, "shift": 2,
                "conv": 3, "h": 2, "idx": 0}


def cache_specs(tree: Any, mesh: Mesh, cfg: ModelConfig,
                batch: tuple) -> Any:
    """KV-cache / recurrent-state specs."""
    total = math.prod(_axis_size(mesh, a) for a in batch)

    def spec(path, leaf):
        names = _names(path)
        name = names[-1]
        shape = tuple(leaf.shape)
        if name == "idx" or len(shape) == 0:
            return P()
        # leading stack dim from the layer-group stack?
        stack = 1 if (len(names) >= 3 and "groups" in names and
                      len(shape) > _CACHE_RANKS.get(name, 0)) else 0
        lead = (None,) * stack
        body = shape[stack:]
        # batch axes only when the batch dim divides (long_500k: B=1)
        if body and body[0] % max(total, 1) == 0 and batch:
            bspec = batch if len(batch) > 1 else batch[0]
        else:
            bspec = None
        if name in ("k", "v"):            # (B, ring, K, hd): seq → model
            return P(*lead, bspec, _fits(body[1], mesh, "model"), None, None)
        if name in ("xk", "xv"):          # (B, F, H, hd)
            return P(*lead, bspec, None, _fits(body[2], mesh, "model"), None)
        if name == "wkv":                 # (B, H, hd, hd)
            return P(*lead, bspec, _fits(body[1], mesh, "model"), None, None)
        if name == "shift":               # (B, D)
            return P(*lead, bspec, _fits(body[1], mesh, "model"))
        if name == "conv":                # (B, cw-1, rd)
            return P(*lead, bspec, None, _fits(body[2], mesh, "model"))
        if name == "h":                   # (B, rd)
            return P(*lead, bspec, _fits(body[1], mesh, "model"))
        return P(*(None,) * len(shape))
    return tree_map_with_path(spec, tree)


def batch_specs(batch_tree: Any, mesh: Mesh, batch: tuple) -> Any:
    """Batch specs: the leading dim over the batch axes where it divides
    (long_500k's batch of 1 is replicated)."""
    bspec = batch if len(batch) > 1 else (batch[0] if batch else None)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        b = bspec
        if shape[0] == 1 or (isinstance(b, tuple) and
                             shape[0] % math.prod(_axis_size(mesh, a)
                                                  for a in batch) != 0) \
           or (isinstance(b, str) and shape[0] % _axis_size(mesh, b) != 0):
            b = None
        return P(b, *((None,) * (len(shape) - 1)))
    return tree_map_with_path(spec, batch_tree)


def leading_axis_specs(tree: Any, axis: str) -> Any:
    """Specs of a stacked tree: the leading dim on ``axis``, the rest
    replicated (the pod-stacked adapter and optimizer state)."""
    return tree_map(lambda t: P(axis, *(None,) * (t.dim() - 1))
                    if hasattr(t, "dim") else t, tree)


def shard_factor(spec: tuple, mesh: Mesh) -> int:
    """How many ways ``spec`` splits a tensor on ``mesh``: the product of
    the sizes of every axis it names."""
    n = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                n *= _axis_size(mesh, a)
    return n


def to_placements(spec: tuple, mesh: Mesh) -> tuple:
    """``spec`` as one ``torch.distributed.tensor`` placement per mesh
    axis: ``Shard(dim)`` where the axis splits tensor dim ``dim``, else
    ``Replicate()``."""
    # imported here: torch.distributed.tensor takes ~1 s to import
    from torch.distributed.tensor.placement_types import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dim = next((i for i, ax in enumerate(spec)
                    if axis == ax or (isinstance(ax, tuple) and axis in ax)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)
