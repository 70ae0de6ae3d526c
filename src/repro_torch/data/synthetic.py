"""Synthetic datasets (no real corpora).

Two generators:
- classification: class-conditional token unigram sources — the federated
  benchmarks' stand-ins for SST-2 / AG_NEWS / CIFAR; non-IID splits come from
  :mod:`repro_torch.data.partition`.
- language modelling: a Zipf-weighted order-1 Markov source, used by the
  end-to-end ~100M training example so the loss actually has structure to
  learn.

A copy of ``repro.data.synthetic`` (numpy only): the same seeds give the
same arrays in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ClassificationData(NamedTuple):
    tokens: np.ndarray   # (N, S) int32
    labels: np.ndarray   # (N,) int32


def make_classification_data(seed: int, n_samples: int, seq_len: int,
                             vocab: int, n_classes: int,
                             class_sep: float = 2.0,
                             class_seed: int = 1234) -> ClassificationData:
    """Each class k draws tokens from softmax(class_sep · z_k) with
    z_k ~ N(0, I_vocab); harder (more overlap) as class_sep → 0.

    ``class_seed`` fixes the class-conditional distributions INDEPENDENTLY
    of the sampling seed, so train/test splits generated with different
    seeds describe the same classes."""
    rng = np.random.default_rng(seed)
    class_rng = np.random.default_rng(class_seed)
    class_logits = class_sep * class_rng.standard_normal((n_classes, vocab))
    probs = np.exp(class_logits - class_logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    labels = rng.integers(0, n_classes, n_samples).astype(np.int32)
    tokens = np.empty((n_samples, seq_len), np.int32)
    for k in range(n_classes):
        idx = np.nonzero(labels == k)[0]
        tokens[idx] = rng.choice(vocab, size=(idx.size, seq_len), p=probs[k])
    return ClassificationData(tokens, labels)


def make_federated_classification(seed: int, n_clients: int, n_train: int,
                                  n_test: int, seq_len: int, vocab: int,
                                  n_classes: int, *, alpha: float = 0.5,
                                  drift: float = 0.0, n_groups: int = 3,
                                  class_sep: float = 1.2,
                                  class_seed: int = 1234):
    """Per-client federated classification with BOTH heterogeneity axes the
    PFL literature distinguishes:

    - label skew: per-client label proportions ~ Dir(α)  (paper Fig 7);
    - concept shift: clients belong to ``n_groups`` latent groups; group g
      perturbs every class-conditional token distribution by
      ``drift · u_{g,k}``.  Clients in the same group share concepts —
      exactly the similarity structure CE-LoRA's personalized aggregation
      (GMM/OT data similarity + CKA) is designed to exploit, and the regime
      where naive FedAvg mixes conflicting concepts.

    Returns (ctrain, ctest, group_of_client): lists of {'tokens','labels'}.
    """
    rng = np.random.default_rng(seed)
    class_rng = np.random.default_rng(class_seed)
    base_logits = class_sep * class_rng.standard_normal((n_classes, vocab))
    group_drift = class_rng.standard_normal((n_groups, n_classes, vocab))
    group_of = rng.integers(0, n_groups, n_clients)

    def sample(client, n, srng):
        g = group_of[client]
        logits = base_logits + drift * group_drift[g]
        probs = np.exp(logits - logits.max(1, keepdims=True))
        probs /= probs.sum(1, keepdims=True)
        props = srng.dirichlet([alpha] * n_classes)
        labels = srng.choice(n_classes, size=n, p=props).astype(np.int32)
        toks = np.empty((n, seq_len), np.int32)
        for k in range(n_classes):
            idx = np.nonzero(labels == k)[0]
            if idx.size:
                toks[idx] = srng.choice(vocab, size=(idx.size, seq_len),
                                        p=probs[k])
        return {"tokens": toks, "labels": labels}

    ctrain, ctest = [], []
    for ci in range(n_clients):
        srng = np.random.default_rng(seed + 1000 + ci)
        # train/test from the SAME per-client distribution (personalized eval)
        both = sample(ci, n_train + n_test, srng)
        ctrain.append({"tokens": both["tokens"][:n_train],
                       "labels": both["labels"][:n_train]})
        ctest.append({"tokens": both["tokens"][n_train:],
                      "labels": both["labels"][n_train:]})
    return ctrain, ctest, group_of


def make_lm_data(seed: int, n_tokens: int, vocab: int,
                 zipf_a: float = 1.2, order1_weight: float = 0.7) -> np.ndarray:
    """Token stream mixing a Zipf unigram with a sparse order-1 transition."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    unigram = ranks ** (-zipf_a)
    unigram /= unigram.sum()
    succ = rng.integers(0, vocab, size=(vocab, 4))   # 4 favoured successors
    out = np.empty(n_tokens, np.int32)
    out[0] = rng.choice(vocab, p=unigram)
    uni_draws = rng.choice(vocab, size=n_tokens, p=unigram)
    pick_markov = rng.random(n_tokens) < order1_weight
    succ_col = rng.integers(0, 4, size=n_tokens)
    for t in range(1, n_tokens):
        out[t] = succ[out[t - 1], succ_col[t]] if pick_markov[t] else uni_draws[t]
    return out


def lm_batches(stream: np.ndarray, batch: int, seq_len: int, seed: int = 0):
    """Infinite iterator of {'tokens','labels'} next-token batches."""
    rng = np.random.default_rng(seed)
    n = stream.size - seq_len - 1
    while True:
        starts = rng.integers(0, n, batch)
        toks = np.stack([stream[s:s + seq_len] for s in starts])
        labs = np.stack([stream[s + 1:s + seq_len + 1] for s in starts])
        yield {"tokens": toks.astype(np.int32), "labels": labs.astype(np.int32)}
