"""Client sampling + participation planning (partial-participation FL).

The numpy-only planning half of ``repro.core.sampling``, copied: the same
``(round, seed, config)`` gives the same :class:`ParticipationPlan` in both
packages.  Each round the server samples a client subset; a deterministic
straggler model may drop some of them after local fit.

Samplers (``FedConfig.sampler``):

* ``"uniform"`` — k clients uniformly without replacement.
* ``"weighted"`` — without replacement, inclusion probability proportional
  to the client's local sample count.
* ``"round_robin"`` — deterministic sliding window of k consecutive client
  ids (mod m).

Straggler model (``FedConfig.straggler_frac``): after local fit,
``floor(frac·k)`` of the sampled clients are dropped (uniformly, from a
round-keyed RNG stream independent of the sampler's), capped so at least
one client always completes.

All randomness is derived from ``np.random.default_rng((seed, round, tag))``.
:func:`stack_plans` packs a run's plans into the scan engine's
:class:`PlanStack`; :class:`LatencyModel` draws the async engine's seeded
per-client latencies (the JAX package's numpy streams, bit for bit).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

SAMPLERS = ("uniform", "weighted", "round_robin")
LATENCIES = ("uniform", "lognormal", "exp")

_SAMPLE_TAG = 0x5A17
_STRAGGLE_TAG = 0xD209
_LATENCY_TAG = 0x1A7E


@dataclasses.dataclass(frozen=True)
class ParticipationPlan:
    """One round's participation outcome (all arrays sorted client ids)."""
    round: int
    sampled: np.ndarray       # ids sampled at round start (train locally)
    dropped: np.ndarray       # sampled but straggled (no upload/downlink)
    participants: np.ndarray  # sampled minus dropped (complete the round)

    @property
    def n_participants(self) -> int:
        return int(self.participants.size)

    def mask(self, m: int, *, which: str = "participants") -> np.ndarray:
        """Boolean (m,) membership mask (``which`` ∈ plan field names)."""
        out = np.zeros(m, bool)
        out[getattr(self, which)] = True
        return out

    @property
    def cohort(self) -> np.ndarray:
        """The client ids whose state a host-resident store must bring to
        the device this round: ``sampled`` (stragglers train too, so their
        state advances although their upload is dropped)."""
        return self.sampled

    def cohort_mask(self) -> np.ndarray:
        """Boolean (k,) participation mask over the sorted cohort: entry j
        is True iff ``sampled[j]`` completed the round, i.e.
        ``mask(m)[sampled]``."""
        return np.isin(self.sampled, self.participants)


def n_sampled(m: int, participation: float) -> int:
    """Clients sampled per round: round(participation·m), clamped to [1, m]."""
    if not 0.0 < participation <= 1.0:
        raise ValueError(f"participation must be in (0, 1]; got {participation}")
    return max(1, min(m, int(round(participation * m))))


def sample_clients(sampler: str, m: int, k: int, rnd: int, seed: int,
                   sample_counts: Optional[Sequence[int]] = None
                   ) -> np.ndarray:
    """Sample ``k`` of ``m`` client ids for round ``rnd`` (sorted, unique)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler={sampler!r}; expected one of {SAMPLERS}")
    if sampler == "round_robin":
        start = (rnd * k) % m
        return np.sort(np.arange(start, start + k) % m)
    rng = np.random.default_rng((seed, rnd, _SAMPLE_TAG))
    if sampler == "weighted":
        if sample_counts is None:
            raise ValueError("weighted sampler needs sample_counts")
        p = np.asarray(sample_counts, np.float64)
        if p.shape != (m,) or np.any(p < 0) or p.sum() <= 0:
            raise ValueError(f"bad sample_counts for weighted sampler: {p}")
        return np.sort(rng.choice(m, size=k, replace=False, p=p / p.sum()))
    return np.sort(rng.choice(m, size=k, replace=False))


def drop_stragglers(sampled: np.ndarray, straggler_frac: float, rnd: int,
                    seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Split ``sampled`` into (participants, dropped): ``floor(frac·k)``
    uniform drops, always leaving ≥ 1 participant.  Deterministic in
    (seed, rnd); independent of the sampler's RNG stream."""
    if not 0.0 <= straggler_frac < 1.0:
        raise ValueError(f"straggler_frac must be in [0, 1); got {straggler_frac}")
    k = sampled.size
    n_drop = min(int(straggler_frac * k), k - 1)
    if n_drop == 0:
        return sampled, np.empty(0, sampled.dtype)
    rng = np.random.default_rng((seed, rnd, _STRAGGLE_TAG))
    drop_pos = rng.choice(k, size=n_drop, replace=False)
    keep = np.ones(k, bool)
    keep[drop_pos] = False
    return sampled[keep], np.sort(sampled[~keep])


def build_plan(sampler: str, m: int, participation: float,
               straggler_frac: float, rnd: int, seed: int,
               sample_counts: Optional[Sequence[int]] = None
               ) -> ParticipationPlan:
    """The round's full participation outcome (sample, then straggle)."""
    k = n_sampled(m, participation)
    sampled = sample_clients(sampler, m, k, rnd, seed, sample_counts)
    participants, dropped = drop_stragglers(sampled, straggler_frac, rnd, seed)
    return ParticipationPlan(rnd, sampled, dropped, participants)


def full_plan(m: int, rnd: int) -> ParticipationPlan:
    """The degenerate everyone-participates plan (participation=1, no
    stragglers) — what the runtime uses on its legacy full-participation
    fast path."""
    ids = np.arange(m)
    return ParticipationPlan(rnd, ids, np.empty(0, ids.dtype), ids)


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Seeded per-client round-trip latency of the async engine: every
    dispatched client finishes after a latency drawn from a wave-keyed
    ``default_rng`` stream, so the arrival order is a function of ``(seed,
    config)`` alone.

    Kinds: ``"uniform"`` (every draw is ``scale``: a whole wave arrives at
    once, the zero-staleness limit), ``"lognormal"`` (``scale ·
    exp(sigma·N(0,1))``, heavy-tailed) and ``"exp"`` (``scale · Exp(1)``).
    """
    kind: str = "uniform"
    scale: float = 1.0
    sigma: float = 0.5

    def __post_init__(self):
        if self.kind not in LATENCIES:
            raise ValueError(
                f"latency kind={self.kind!r}; expected one of {LATENCIES}")
        if self.scale <= 0:
            raise ValueError(f"latency scale must be > 0; got {self.scale}")

    def draw(self, m: int, wave: int, seed: int) -> np.ndarray:
        """Per-client latencies (m,) float64 of dispatch wave ``wave``."""
        if self.kind == "uniform":
            return np.full(m, self.scale, np.float64)
        rng = np.random.default_rng((seed, wave, _LATENCY_TAG))
        if self.kind == "lognormal":
            return self.scale * np.exp(self.sigma * rng.standard_normal(m))
        return self.scale * rng.exponential(1.0, size=m)

    def draw_retry(self, wave: int, client: int, attempt: int,
                   seed: int) -> float:
        """One re-dispatch latency of ``(wave, client)``, ``attempt >= 1``,
        keyed ``(seed, wave, client, attempt, tag)``: independent of the
        wave's draw (attempt 0) and of every other client's stream."""
        if self.kind == "uniform":
            return float(self.scale)
        rng = np.random.default_rng(
            (seed, int(wave), int(client), int(attempt), _LATENCY_TAG))
        if self.kind == "lognormal":
            return float(self.scale * np.exp(
                self.sigma * rng.standard_normal()))
        return float(self.scale * rng.exponential(1.0))


@dataclasses.dataclass(frozen=True)
class PlanStack:
    """All rounds' participation plans as arrays — the input layout of the
    scan engine (:mod:`.fed_engine`), which reads one row per round instead
    of one :class:`ParticipationPlan` per round.

    Shapes are static across rounds by construction: with participation and
    straggler fraction fixed, every round samples exactly ``k`` clients and
    drops exactly ``floor(frac·k)`` of them, so ``sampled_ids`` packs to a
    dense (rounds, k) matrix with no padding.
    """
    sampled_mask: np.ndarray      # (rounds, m) bool — trained this round
    participant_mask: np.ndarray  # (rounds, m) bool — uplinked + installed
    sampled_ids: np.ndarray       # (rounds, k) int32, each row sorted
    n_participants: np.ndarray    # (rounds,) int64


def stack_plans(plans: Sequence[ParticipationPlan], m: int) -> PlanStack:
    """Stack per-round plans into the :class:`PlanStack` the scan engine
    reads row by row.  Requires a round-invariant sampled count (true for
    any fixed ``FedConfig``)."""
    ks = {int(p.sampled.size) for p in plans}
    if len(ks) != 1:
        raise ValueError(f"stack_plans needs a round-invariant sampled "
                         f"count; got sizes {sorted(ks)}")
    return PlanStack(
        sampled_mask=np.stack([p.mask(m, which="sampled") for p in plans]),
        participant_mask=np.stack([p.mask(m) for p in plans]),
        sampled_ids=np.stack([p.sampled.astype(np.int32) for p in plans]),
        n_participants=np.asarray([p.n_participants for p in plans],
                                  np.int64))
