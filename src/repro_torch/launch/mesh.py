"""Device meshes of the port: PyTorch port of ``repro.launch.mesh``.

A :class:`Mesh` here is a mesh of ONE process over the node's devices (or
an abstract one over none): named axes, their sizes, and a numpy object
array of ``torch.device`` (``None`` for an abstract mesh).  It is not a
``torch.distributed.DeviceMesh``, which needs one process per device.

* :func:`make_production_mesh` — the abstract production layouts, 16×16
  ``("data", "model")`` or 2×16×16 ``("pod", "data", "model")``: the
  ``pod`` axis is the federated-client boundary (only the r×r C matrices
  cross it).  Nothing is placed on them; :mod:`.sharding` and
  :mod:`.dryrun` read them.
* :func:`make_host_mesh` — 1×1 over the run's device.
* :func:`make_client_mesh` — the 1-D ``("clients",)`` mesh that lays the
  leading client axis of a stacked population over the node's devices:
  ``client_parallelism="shard"`` and ``client_store="sharded"``.  With
  ``devices=None`` those are the node's CUDA devices (one on a one-card
  machine, so d = 1 there); a list of devices emulates more, e.g.
  ``[torch.device("cpu")] * 4``.

:func:`shard_clients` splits a stacked tree into d row blocks, block i on
mesh device i; :func:`join_clients` is its inverse on one device (at
d = 1 the block itself, no copy).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


class PartitionSpec(tuple):
    """How a tensor splits over a mesh: one entry per tensor dim, an axis
    name, a tuple of axis names, or ``None`` (replicated along that dim).
    A tuple, so it compares equal to ``tuple(jax PartitionSpec)``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """Named mesh axes over a numpy array of devices (``None`` entries: an
    abstract mesh).  ``shape`` maps each axis to its size, as JAX's
    ``mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def abstract(self) -> bool:
        return all(d is None for d in self.devices.flat)

    def __repr__(self) -> str:
        kind = "abstract " if self.abstract else ""
        return f"Mesh({kind}{self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract production layout: 16×16 or 2×16×16."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, None, dtype=object), axes)


def make_host_mesh(device=None) -> Mesh:
    """1×1 ``("data", "model")`` over the run's device (default: the
    first card)."""
    dev = torch.device(device if device is not None else "cuda")
    return Mesh(np.full((1, 1), dev, dtype=object), ("data", "model"))


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# ---------------------------------------------------------------------------
# the federated client axis
# ---------------------------------------------------------------------------

def node_devices() -> list:
    """The node's CUDA devices."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def run_devices(device) -> list:
    """The devices a run on ``device`` lays its client axis over: the
    node's CUDA devices for a run on a card, the run's device alone
    otherwise."""
    dev = torch.device(device)
    return node_devices() if dev.type == "cuda" else [dev]


def make_client_mesh(n_clients: Optional[int] = None,
                     devices=None) -> Mesh:
    """1-D ``("clients",)`` mesh over the largest count d of ``devices``
    that divides ``n_clients`` (all of them when ``n_clients`` is None), so
    the client axis splits evenly; d = 1 on a one-card node, where the
    shard path is exactly the vmap path.  ``devices=None``: the node's
    CUDA devices; there is no CPU mesh by default."""
    devices = node_devices() if devices is None else list(devices)
    if not devices:
        raise RuntimeError("make_client_mesh: no CUDA device on this node; "
                           "pass devices=[...] (e.g. [torch.device('cpu')] "
                           "* d) to lay the client axis over others")
    if n_clients is None:
        d = len(devices)
    else:
        d = max(k for k in range(1, len(devices) + 1) if n_clients % k == 0)
    arr = np.empty(d, dtype=object)
    arr[:] = [torch.device(x) for x in devices[:d]]
    return Mesh(arr, ("clients",))


def client_axis_sharding(mesh: Mesh, tree: Any) -> Any:
    """The spec tree of a stacked client tree: the leading (client) axis
    of every leaf on ``clients``, everything else replicated within a
    client's block."""
    return tree_map(lambda t: PartitionSpec("clients",
                                            *(None,) * (t.dim() - 1)), tree)


def shard_clients(mesh: Mesh, tree: Any) -> list:
    """Lay a stacked client tree (leaves (m, …)) over the ``clients`` axis:
    d trees, block i holding rows [i·m/d, (i+1)·m/d) on mesh device i.  At
    d = 1 the block is the tree itself when it lies on the mesh device."""
    d = mesh.shape["clients"]
    m = int(tree_leaves(tree)[0].shape[0])
    if m % d:
        raise ValueError(f"{d} mesh devices do not divide m={m} clients")
    if d == 1:
        return [tree_map(lambda t: t.to(mesh.devices.flat[0]), tree)]
    per = m // d
    return [tree_map(lambda t, i=i, dev=dev: t[i * per:(i + 1) * per]
                     .to(dev), tree)
            for i, dev in enumerate(mesh.devices.flat)]


def join_clients(blocks: Sequence[Any], device) -> Any:
    """The stacked tree of :func:`shard_clients`' ``blocks`` on ``device``:
    one block moved there (itself when it lies there already), or the
    blocks concatenated in order."""
    dev = torch.device(device)
    if len(blocks) == 1:
        return tree_map(lambda t: t.to(dev), blocks[0])
    return tree_map(lambda *bs: torch.cat([b.to(dev) for b in bs]),
                    *blocks)
