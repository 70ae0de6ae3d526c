"""Seeded fault injection for the federated runtime: PyTorch port of
``repro.core.faults``.

Cross-device deployments fail in ways the straggler drop does not model:
devices crash before uploading, uplinks vanish in transit, payloads arrive
mangled, and a client's local fit occasionally diverges and ships a
blown-up update.  A frozen :class:`FaultModel` maps ``(seed, round,
client, attempt)`` to per-event booleans via ``np.random.default_rng((seed,
rnd, client, _FAULT_TAG, attempt))`` — the JAX package's numpy stream, so
both packages (and the loop and vmap paths) see the identical fault
schedule for a given config, bit for bit.

Event taxonomy (each an independent Bernoulli per (round, client)):

* ``crash`` — the device dies BEFORE uploading: its local work is lost
  (resident state rolls back to the round start), nothing crosses the
  wire, no bytes are priced.
* ``loss`` — the upload is sent (bytes ARE priced) but never arrives; the
  server aggregates without it.
* ``corrupt`` — the upload arrives mangled: NaN-fill, Inf-fill, or a bit
  flip on the encoded wire tree (``corrupt_mode``).  Admission control
  (:mod:`.admission`) keeps the mangled rows out of the aggregate.
* ``divergent`` — the local fit blew up: the uplink carries a
  ``divergent_scale``-scaled payload (huge but finite — what the norm gate
  must catch) and the client's resident state reverts to the round start.

All rates default to 0.0; :attr:`FaultModel.active` is then False and the
runtime takes its fault-free path untouched.

The payload manglers are pure tree maps over tensors.  The bit flip XORs
one high bit of the wire representation through ``Tensor.view`` (no
arithmetic): bit 6 of int8/uint8 codes (the packed high nibble for int4),
bit 14 of a bf16, bit 30 of an f32 — bit for bit what the JAX package's
``bitcast_convert_type`` gives.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import compress
from repro_torch.tree import tree_map

FAULT_EVENTS = ("crash", "loss", "corrupt", "divergent")
CORRUPT_MODES = ("nan", "inf", "bitflip")

# fold key separating fault draws from the sampler / straggler streams of
# .sampling (the JAX package's constant)
_FAULT_TAG = 0xFA17


@dataclasses.dataclass(frozen=True)
class FaultDraw:
    """One round's fault outcome: four (m,) boolean event masks."""
    crash: np.ndarray
    loss: np.ndarray
    corrupt: np.ndarray
    divergent: np.ndarray

    @classmethod
    def none(cls, m: int) -> "FaultDraw":
        z = np.zeros(m, bool)
        return cls(z, z.copy(), z.copy(), z.copy())


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded per-(round, client) fault events (all rates in [0, 1))."""
    crash: float = 0.0
    loss: float = 0.0
    corrupt: float = 0.0
    corrupt_mode: str = "nan"
    divergent: float = 0.0
    divergent_scale: float = 1e4

    def __post_init__(self):
        for name in FAULT_EVENTS:
            rate = getattr(self, name)
            if not 0.0 <= rate < 1.0:
                raise ValueError(
                    f"fault_{name} rate must be in [0, 1); got {rate}")
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(f"fault_corrupt_mode={self.corrupt_mode!r}; "
                             f"expected one of {CORRUPT_MODES}")
        if self.divergent_scale <= 1.0:
            raise ValueError(f"fault_divergent_scale must be > 1; "
                             f"got {self.divergent_scale}")

    @property
    def active(self) -> bool:
        """True iff any event can fire; the runtime gates every fault-path
        op on it."""
        return (self.crash > 0 or self.loss > 0 or self.corrupt > 0
                or self.divergent > 0)

    def draw_one(self, rnd: int, client: int, seed: int, attempt: int = 0
                 ) -> tuple[bool, bool, bool, bool]:
        """One (round, client) draw → (crash, loss, corrupt, divergent)."""
        if not self.active:
            return (False, False, False, False)
        rng = np.random.default_rng(
            (seed, int(rnd), int(client), _FAULT_TAG, int(attempt)))
        u = rng.random(4)
        return (bool(u[0] < self.crash), bool(u[1] < self.loss),
                bool(u[2] < self.corrupt), bool(u[3] < self.divergent))

    def draw(self, m: int, rnd: int, seed: int, attempt: int = 0
             ) -> FaultDraw:
        """All m clients' events for one round, elementwise
        :meth:`draw_one` per client."""
        if not self.active:
            return FaultDraw.none(m)
        out = np.zeros((4, m), bool)
        for i in range(m):
            out[:, i] = self.draw_one(rnd, i, seed, attempt)
        return FaultDraw(out[0], out[1], out[2], out[3])


def fault_model_of(fed: Any) -> FaultModel:
    """The :class:`FaultModel` of a ``FedConfig`` (validates its
    ``fault_*`` knobs)."""
    return FaultModel(crash=fed.fault_crash, loss=fed.fault_loss,
                      corrupt=fed.fault_corrupt,
                      corrupt_mode=fed.fault_corrupt_mode,
                      divergent=fed.fault_divergent,
                      divergent_scale=fed.fault_divergent_scale)


# ---------------------------------------------------------------------------
# payload mangling
# ---------------------------------------------------------------------------

def _row_mask(mask: Any, leaf: torch.Tensor) -> torch.Tensor:
    """A boolean (m,) mask on ``leaf``'s device, broadcast over its
    trailing axes."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=leaf.device)
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def scale_rows(tree: Any, mask: Any, scale: float) -> Any:
    """Multiply rows ``mask`` of a stacked payload by ``scale`` — the
    divergent-fit blowup (huge but finite)."""
    return tree_map(
        lambda l: torch.where(_row_mask(mask, l), l * scale, l), tree)


def _flip_leaf(l: torch.Tensor) -> torch.Tensor:
    """Flip one high bit of the leaf's wire representation: bit 6 of int
    codes, bit 14 of a bf16, bit 30 of an f32 (other float types go
    through f32)."""
    if l.dtype in (torch.int8, torch.uint8):
        return l ^ 0x40
    if l.dtype == torch.bfloat16:
        return (l.view(torch.int16) ^ (1 << 14)).view(torch.bfloat16)
    bits = l.float().contiguous().view(torch.int32) ^ (1 << 30)
    return bits.view(torch.float32).to(l.dtype)


def bitflip_wire(enc: dict) -> dict:
    """Bit-flip every code leaf of an encoded wire tree (scales intact)."""
    return {"codes": tree_map(_flip_leaf, enc["codes"]),
            "scales": enc["scales"]}


def corrupt_rows(tree: Any, mask: Any, mode: str) -> Any:
    """Mangle rows ``mask`` of a stacked f32 payload in transit."""
    def leaf(l):
        if mode == "nan":
            bad = torch.full_like(l, float("nan"))
        elif mode == "inf":
            bad = torch.full_like(l, float("inf"))
        else:
            bad = _flip_leaf(l)
        return torch.where(_row_mask(mask, l), bad, l)
    return tree_map(leaf, tree)


def corrupt_served(codec, enc: dict, served: Any, mask: Any,
                   mode: str) -> Any:
    """The server's decoded view of a round's stacked uploads with rows
    ``mask`` corrupted in transit.  ``mode="bitflip"`` under a real codec
    flips the ENCODED wire tree and decodes it again (the server sees what
    a flipped wire bit dequantizes to); otherwise the mangling applies to
    the decoded rows directly."""
    if mode == "bitflip" and codec is not None and not codec.is_identity:
        bad = compress.decode_stacked(codec, bitflip_wire(enc), served)
        return tree_map(lambda g, b: torch.where(_row_mask(mask, g), b, g),
                        served, bad)
    return corrupt_rows(served, mask, mode)


def corrupt_one(codec, enc: dict, served: Any, mode: str) -> Any:
    """Single-client form of :func:`corrupt_served` (the loop path): the
    WHOLE tree is the corrupted upload."""
    if mode == "bitflip" and codec is not None and not codec.is_identity:
        return compress.decode(codec, bitflip_wire(enc), served)
    if mode == "nan":
        return tree_map(lambda l: torch.full_like(l, float("nan")), served)
    if mode == "inf":
        return tree_map(lambda l: torch.full_like(l, float("inf")), served)
    return tree_map(_flip_leaf, served)


def zero_rows(tree: Any, keep: Any) -> Any:
    """Zero every row NOT in ``keep``.  Rejected or undelivered rows may
    hold NaN/Inf; their aggregation weight is 0, but 0 × NaN is NaN, so the
    server zeroes them before aggregating."""
    return tree_map(
        lambda l: torch.where(_row_mask(keep, l), l, torch.zeros_like(l)),
        tree)
