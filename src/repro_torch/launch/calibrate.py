"""Two-point depth calibration of the LM train and prefill cells (port of
``repro/launch/calibrate.py``).

The port's layer loop is Python, so the counter counts every layer a
cell runs; what a deep model costs is still priced from two shallow
runs, to save the host the time of tracing 64-96 layers.  For each LM
(shape x mesh) the SAME architecture runs at two depths L1 < L2 (2 and
4, the reference's; a stack whose layers repeat with a period p > 2 —
llama4's dense/MoE and local/global pattern, p = 4 — takes p and 2p, so
that both depths hold whole periods), giving

    per_layer = (X(L2) - X(L1)) / (L2 - L1)     exactly, for X in
    nonscan   = X(L1) - L1 * per_layer          {flops, bytes, coll,
    total(L)  = nonscan + L * per_layer          coll_s, peak}

The depth runs are full width; only the layer count differs.
"""
from __future__ import annotations

import dataclasses
import math

KEYS = ("flops", "bytes", "coll", "coll_s", "peak")


def depths(cfg) -> tuple[int, int]:
    """The two depths of the fit: (2, 4), or (p, 2p) for a layer pattern
    of period p > 2."""
    p = cfg.moe_every
    if cfg.attn_kind != "full":
        p = math.lcm(p, cfg.global_every)
    return (2, 4) if p <= 2 else (p, 2 * p)


def measure(cell, mesh) -> dict:
    """The counted per-chip terms of one run of ``cell`` on ``mesh``
    (under a fake-tensor mode: the dry-run's)."""
    from repro_torch.launch.roofline import COLLECTIVE_KINDS, WorkCounter
    step = cell.build(mesh)
    c = WorkCounter()
    c.track(step.inputs)
    with c:
        step.run()
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "coll": float(sum(c.coll[k] for k in COLLECTIVE_KINDS)),
            "coll_s": float(c.coll_s), "peak": float(c.peak)}


def fit(m1: dict, m2: dict, l1: int, l2: int, L: int) -> dict:
    out = {}
    for k in KEYS:
        per_layer = max((m2[k] - m1[k]) / (l2 - l1), 0.0)
        nonscan = max(m1[k] - l1 * per_layer, 0.0)
        out[k] = nonscan + L * per_layer
        out[k + "_per_layer"] = per_layer
        out[k + "_nonscan"] = nonscan
    return out


def lm_calibration(full_cfg, shape_name: str, arch: str, mesh) -> dict:
    """Per-chip totals {flops, bytes, coll, coll_s, peak} of the
    full-depth model fitted from two depths, plus the raw two-point data
    (``depth_a``, ``depth_b`` and their layer counts)."""
    from repro_torch.configs.cells import lm_cell
    l1, l2 = depths(full_cfg)
    m = [measure(lm_cell(dataclasses.replace(full_cfg, n_layers=L),
                         shape_name, arch), mesh) for L in (l1, l2)]
    out = fit(m[0], m[1], l1, l2, full_cfg.n_layers)
    out["depths"] = [l1, l2]
    out["depth_a"], out["depth_b"] = m
    return out
