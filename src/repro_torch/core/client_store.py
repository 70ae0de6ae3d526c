"""Population residency of the vectorized runtime: PyTorch port of the
device half of ``repro.core.client_store``.

:func:`make_store` returns the store of a backend; only ``"device"`` is
ported — the whole population as one stacked state (leaves (m, …)) on the
device, which the eager vectorized round updates wholesale.  The
``"host"`` (cohort streaming from host memory) and ``"sharded"`` (client
axis over a device mesh) backends raise ``NotImplementedError`` (ROADMAP,
Queue 1: "host / sharded client stores").
"""
from __future__ import annotations

from typing import Any, Sequence

from repro_torch.core import client_batch

STORE_BACKENDS = ("device", "sharded", "host")


def make_store(backend: str, states: Sequence[Any], *,
               parallelism: str = "vmap") -> "DeviceClientStore":
    """The population store for ``backend`` from m per-client states.
    ``parallelism="shard"`` (the client axis over a device mesh) is not
    ported."""
    if backend not in STORE_BACKENDS:
        raise ValueError(f"client_store={backend!r}; "
                         f"expected one of {STORE_BACKENDS}")
    if backend != "device":
        raise NotImplementedError(
            f"client_store={backend!r} is not ported yet (ROADMAP, Queue 1: "
            f"'host / sharded client stores'); the port runs "
            f"client_store='device'")
    if parallelism == "shard":
        raise NotImplementedError(
            "client_parallelism='shard' is not ported yet (ROADMAP, Queue 1: "
            "'launch/mesh.py'); the port runs 'loop' and 'vmap'")
    return DeviceClientStore(states)


class DeviceClientStore:
    """The whole population as one device-resident stacked state.
    ``gather`` / ``scatter`` are plain row indexing, so that every store
    keeps one contract."""

    backend = "device"

    def __init__(self, states: Sequence[Any]):
        self.m = len(states)
        self._stacked = client_batch.stack_states(states)

    def resident(self) -> Any:
        """The stacked population the round updates; hand an updated one
        back through :meth:`adopt`."""
        return self._stacked

    def adopt(self, stacked: Any) -> None:
        """Install an updated stacked population as current."""
        self._stacked = stacked

    def gather(self, ids) -> Any:
        return client_batch.gather_clients(self._stacked, ids)

    def scatter(self, ids, values: Any) -> None:
        self._stacked = client_batch.scatter_clients(self._stacked, ids,
                                                     values)

    def unstack(self) -> list:
        return client_batch.unstack_states(self._stacked)
