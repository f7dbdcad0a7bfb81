"""Seeded synthetic data (port of ``RecsysStream`` in
``repro/data/synthetic.py``).

numpy only, so the same seed gives the same arrays as the reference;
callers move them to a device.  ``TokenStream`` and ``cora_like`` are not
ported yet.
"""
from __future__ import annotations

import numpy as np


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
