"""Minibatch pipeline over in-memory arrays (per-client federated loaders).

A copy of ``repro.data.pipeline`` (numpy only): the same seed gives the
same batches, and ``skip`` the same stream position, in both packages."""
from __future__ import annotations

from typing import Iterator

import numpy as np


class Loader:
    """Shuffling minibatch iterator; yields dicts of numpy arrays."""

    def __init__(self, arrays: dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, drop_last: bool = False):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"arrays of different lengths: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def epoch(self) -> Iterator[dict]:
        order = self.rng.permutation(self.n)
        stop = (self.n // self.batch_size * self.batch_size
                if self.drop_last else self.n)
        for s in range(0, stop, self.batch_size):
            idx = order[s:s + self.batch_size]
            if idx.size == 0:
                return
            yield {k: v[idx] for k, v in self.arrays.items()}

    def batches(self, n_batches: int) -> Iterator[dict]:
        """Exactly n_batches, cycling epochs (resamples if client is small)."""
        done = 0
        while done < n_batches:
            for b in self.epoch():
                if b[next(iter(b))].shape[0] < self.batch_size:
                    # pad small final batches by resampling
                    need = self.batch_size - b[next(iter(b))].shape[0]
                    extra = self.rng.integers(0, self.n, need)
                    b = {k: np.concatenate([v, self.arrays[k][extra]])
                         for k, v in b.items()}
                yield b
                done += 1
                if done >= n_batches:
                    return

    def skip(self, n_batches: int) -> None:
        """Advance the RNG stream exactly as one ``batches(n_batches)`` call
        would, WITHOUT materializing any batch: no gathers, no copies —
        only the per-epoch permutation draw (O(n), RNG-only) and the
        short-batch resample draw are consumed, so a skipped stream and a
        drawn stream are indistinguishable afterwards.  This is what lets
        the scan engine's resume fast-forward ``rounds × m`` draw sessions
        without replaying every minibatch (see repro.core.fed_engine)."""
        full = self.n // self.batch_size
        tail = self.n - full * self.batch_size      # short-batch size, 0 if none
        done = 0
        while done < n_batches:
            self.rng.permutation(self.n)            # epoch() header
            done += min(full, n_batches - done)
            if done >= n_batches:
                return
            if tail and not self.drop_last:
                # the epoch's short final batch: batches() pads it by
                # resampling batch_size - tail extra rows
                self.rng.integers(0, self.n, self.batch_size - tail)
                done += 1
