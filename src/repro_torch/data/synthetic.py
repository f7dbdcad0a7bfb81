"""Seeded synthetic data (port of ``TokenStream``, ``RecsysStream`` and
``cora_like`` in ``repro/data/synthetic.py``).

numpy only, so the same seed gives the same arrays as the reference;
callers move them to a device.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """LM token batches with learnable structure: a hidden permutation pi
    of the vocabulary and the rule ``t[i+1] = pi[(t[i] + t[i-1]) % V]``,
    with uniform noise on a ``noise`` share of the positions."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 noise: float = 0.05):
        self.vocab, self.seq, self.batch = vocab, seq_len, batch
        self.rng = np.random.default_rng(seed)
        self.pi = np.random.default_rng(seed + 1).permutation(vocab)
        self.noise = noise

    def next_batch(self) -> dict:
        """``tokens`` int32[B, S + 1]."""
        B, S, V = self.batch, self.seq, self.vocab
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = self.rng.integers(0, V, B)
        toks[:, 1] = self.rng.integers(0, V, B)
        for i in range(2, S + 1):
            nxt = self.pi[(toks[:, i - 1] + toks[:, i - 2]) % V]
            noise = self.rng.random(B) < self.noise
            toks[:, i] = np.where(noise, self.rng.integers(0, V, B), nxt)
        return {"tokens": toks}

    def shard_for_host(self, batch: dict, host_id: int, n_hosts: int):
        """Host ``host_id``'s rows of the global batch: every host of a
        data-parallel input pipeline materialises only its own slice."""
        tok = batch["tokens"]
        per = tok.shape[0] // n_hosts
        return {"tokens": tok[host_id * per:(host_id + 1) * per]}


class RecsysStream:
    """Multi-hot categorical batches for xDeepFM."""

    def __init__(self, field_sizes, offsets, batch: int, values: int = 3,
                 seed: int = 0):
        self.sizes = np.asarray(field_sizes)
        self.offsets = np.asarray(offsets)
        self.batch, self.values = batch, values
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> dict:
        """``indices`` int32[B, F, V] (global row ids, -1 padding; each
        field holds 1..V values) and ``labels`` int32[B]."""
        B, F, V = self.batch, len(self.sizes), self.values
        idx = np.full((B, F, V), -1, np.int64)
        counts = self.rng.integers(1, V + 1, (B, F))
        for f in range(F):
            vals = self.offsets[f] + self.rng.integers(
                0, self.sizes[f], (B, V))
            for v in range(V):
                idx[:, f, v] = np.where(counts[:, f] > v, vals[:, v], -1)
        # learnable structure: every row has a deterministic hidden
        # weight sin(0.137*row); the label is the sign of the active
        # rows' sum — recoverable by the model's per-row linear term.
        hidden = np.where(idx >= 0, np.sin(0.137 * idx), 0.0)
        h = (hidden.sum(axis=(1, 2)) > 0).astype(np.int32)
        return {"indices": idx.astype(np.int32), "labels": h}


def cora_like(n: int = 2708, e: int = 10556, d: int = 1433,
              classes: int = 7, seed: int = 0):
    """Citation-network-shaped synthetic node-classification data with
    homophily (neighbours share labels more often than not): ``(n, src,
    dst, x float32[n, d], labels)``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    src, dst = [], []
    while len(src) < e:
        a = rng.integers(0, n)
        same = np.where(labels == labels[a])[0]
        b = int(rng.choice(same)) if rng.random() < 0.7 else \
            int(rng.integers(0, n))
        if a != b:
            src.append(a)
            dst.append(b)
    # sparse bag-of-words features correlated with the label
    x = np.zeros((n, d), np.float32)
    words_per_class = d // classes
    for i in range(n):
        base = labels[i] * words_per_class
        k = rng.integers(10, 40)
        cols = base + rng.integers(0, words_per_class, k)
        noise = rng.integers(0, d, k // 3)
        x[i, cols] = 1.0
        x[i, noise] = 1.0
    return n, np.asarray(src), np.asarray(dst), x, labels
