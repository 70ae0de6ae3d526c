"""Server-side uplink admission control: PyTorch port of
``repro.core.admission``.

Every decoded uplink passes a validator before it may touch the aggregate:
a finite check (no NaN/Inf anywhere in the row) plus a norm gate (reject
rows whose L2 norm exceeds ``norm_mult ×`` the running median of previously
*accepted* round medians).  Rejected rows are masked out of aggregation
(the ``participants`` mask renormalizes the eqn-3 / FedAvg weights), their
error-feedback residual rolls back to its pre-round value, and their bytes
are still priced — the upload happened.

The gate state is a ring of the last ``window`` accepted round medians and
the number of rounds that contributed one: two tensors on the run's
device.  On the first round (empty history) the reference is the current
round's median itself, so a cold start still rejects outliers relative to
its own cohort.  Every function takes rows on a leading axis; the masked
median (an +inf-padded sort) keeps every shape static, as in the JAX
package, so the two compute the same reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import compress
from repro_torch.tree import tree_leaves

ADMISSION_MODES = ("none", "norm")


@dataclasses.dataclass(frozen=True)
class AdmissionControl:
    """Admission-gate config (``FedConfig.admission*`` knobs)."""
    mode: str = "none"
    norm_mult: float = 10.0
    window: int = 8

    def __post_init__(self):
        if self.mode not in ADMISSION_MODES:
            raise ValueError(f"admission={self.mode!r}; "
                             f"expected one of {ADMISSION_MODES}")
        if self.norm_mult <= 0:
            raise ValueError(
                f"admission_norm_mult must be > 0; got {self.norm_mult}")
        if self.window < 1:
            raise ValueError(
                f"admission_window must be >= 1; got {self.window}")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"


def control_of(fed: Any) -> AdmissionControl:
    """The :class:`AdmissionControl` of a ``FedConfig`` (validates its
    ``admission*`` knobs)."""
    return AdmissionControl(mode=fed.admission,
                            norm_mult=fed.admission_norm_mult,
                            window=fed.admission_window)


def init_state(window: int, device) -> dict:
    """Fresh gate state on ``device`` (required: the run's device, so that
    the gate never falls to the CPU unasked): an empty (window,) ring of
    accepted round medians and the number of rounds that contributed
    one."""
    return {"meds": torch.zeros((window,), dtype=torch.float32,
                                device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def payload_stats(served: Any) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (L2 norm, all-finite) over a stacked payload tree whose
    leaves carry a leading row axis, the sum of squares taken leaf by leaf
    in the JAX package's order (dict keys sorted)."""
    leaves = tree_leaves(compress._sorted_tree(served))
    n = leaves[0].shape[0]
    dev = leaves[0].device
    sumsq = torch.zeros((n,), dtype=torch.float32, device=dev)
    finite = torch.ones((n,), dtype=torch.bool, device=dev)
    for l in leaves:
        f = l.float().reshape(n, -1)
        sumsq = sumsq + torch.sum(f * f, dim=1)
        finite = finite & torch.all(torch.isfinite(f), dim=1)
    return torch.sqrt(sumsq), finite


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x[mask]`` without dynamic shapes: sort with +inf
    padding, average the two middle order statistics of the masked count.
    0 when the mask is empty.  The order statistics are gathered by a
    one-element index tensor: indexing with a 0-dim tensor would read it
    back to the host (a sync per call on a card)."""
    s = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))[0]
    n = mask.sum()

    def at(i):
        return torch.index_select(s, 0, torch.clamp_min(i, 0).reshape(1))[0]
    lo = at(torch.div(n - 1, 2, rounding_mode="floor"))
    hi = at(torch.div(n, 2, rounding_mode="floor"))
    return torch.where(n > 0, 0.5 * (lo + hi), torch.zeros_like(lo))


def admit(norms: torch.Tensor, finite: torch.Tensor, candidates: Any,
          state: dict, ctl: AdmissionControl) -> tuple[torch.Tensor, dict]:
    """One admission decision: a bool tensor ``accept ⊆ candidates`` and
    the advanced gate state.  Non-finite rows never pass; finite rows pass
    iff their norm is within ``norm_mult ×`` the running-median reference.
    The ring advances only on rounds that accepted something, so a fully
    corrupted round cannot poison the reference.  No host sync."""
    candidates = torch.as_tensor(candidates, dtype=torch.bool,
                                 device=norms.device)
    ok = finite & candidates
    meds, count = state["meds"], state["count"]
    w = meds.shape[0]
    hist_mask = torch.arange(w, device=meds.device) < torch.clamp_max(count,
                                                                      w)
    hist_med = _masked_median(meds, hist_mask)
    round_med = _masked_median(norms, ok)
    ref = torch.where(count > 0, hist_med, round_med)
    accept = ok & (norms <= ctl.norm_mult * ref + 1e-12)
    acc_med = _masked_median(norms, accept)
    any_acc = accept.any()
    slot = torch.arange(w, device=meds.device) == torch.remainder(count, w)
    meds = torch.where(any_acc & slot, acc_med, meds)
    return accept, {"meds": meds, "count": count + any_acc.to(torch.int32)}
