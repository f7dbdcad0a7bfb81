#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # every phase, one CUDA card
    python3 chip_smoke.py --profile  # and a torch.profiler breakdown

Phases, each failing the run (non-zero exit) if it fails:

 1. device report: the card's name and power limit from nvidia-smi;
 2. build: every kernel of ``src/repro_torch/kernels/csrc`` with nvcc
    into ``build/repro_torch`` (timed);
 3. kernels: each CUDA kernel against its plain PyTorch version on the
    card at the main paths' shapes, the SSSP kernels on edge cases too
    (B3 also over full rows; the fused B2 beside the gather + tgt/cand
    kernel it replaced on the main path; B1's single-lane op at cap 4096
    and at the bidirectional route's cap 2^20; B4 in its single form and
    as the pair of minima a pallas round takes in one launch, beside
    ``torch.masked.amin``),
    with tolerance 0 for the SSSP kernels (min, mask and one f32 add are
    exact), the reference's own for the CIN (3e-4) and f32 attention
    (2e-3), and two bf16 steps for bf16 attention (rtol 1.6e-2, atol
    4e-3, inside the reference's 2e-2); median times by CUDA events,
    device times by torch.profiler; then the training kernels: B6's
    forward with the log-sum-exp and its backward (``flash_attn_bwd.cu``)
    at the ``[train]`` qwen3-32b layer in bf16 (each gradient within
    two bf16 steps of its largest magnitude) and at a smaller f32 shape
    (2e-3), against SDPA's backward; ``cin_weight_grad`` and the whole B5
    backward (dx_0 split over 191 fields) at FULL widths, B 512 and
    65,536, within 3e-4 of float64 (of the largest magnitude), against
    the einsum forms;
 4. SSSP main path at full size through ``repro_torch.sssp.Solver``:
    grid(side=1024) via "auto" (must route to frontier), gnp(2^20, 8) via
    "auto" (must route to segment) and via "pallas"; ``solve`` and an
    8-source ``solve_batch`` each, and the grid's segment and pallas
    ``solve``, with the kernels' launch counts read around each run (the
    pallas routes launch B4's pair exactly once a round);
    then distances against scipy's float64 Dijkstra and the backends
    bitwise against each other;
 5. ``[dynamic]``: ``DynamicSolver`` at n = 2^20 (grid via "auto" ->
    frontier, gnp via "auto" -> segment and via "pallas"): 8 tracked
    sources (on the grid the main path's batch: its grid solver is a
    ``DynamicSolver``), ``update`` after 1,024 random edge changes (and
    on gnp a
    pure increase), ``resolve``, each held bitwise against a cold solve
    of the mutated graph and against scipy, launches checked;
    ``[p2p]``: ``LandmarkIndex(k=8)`` on gnp (segment) and the grid
    (pallas), batches of 8 seeded targeted pairs (64 on gnp through
    segment and pallas, 8 on the grid through frontier), every target
    bitwise against the untargeted solve, every seed a lower bound up to
    f32 rounding, then the gnp index's ``apply_delta``;
    ``[bidi]``: ``BidirectionalSolver`` on the same graphs and pairs (8
    grid pairs via "auto" -> frontier, 16 gnp pairs via "auto" ->
    segment), unseeded and seeded from ``[p2p]``'s index, every distance
    bitwise ``[p2p]``'s, every path real edges, B1 launched twice a
    frontier round; then ``update`` with ``[dynamic]``'s delta refreshing
    2 grid and 8 gnp pairs warm, bitwise cold solves and near scipy;
    ``[fleet]``: a segment ``FleetSolver`` over 8 grids of side 128
    (``solve``, ``solve_batch`` [8, 8], stacked deltas, ``update``,
    ``resolve``), every member bitwise its per-graph solve, host reads
    rounds + 2 whatever F; a frontier fleet of 2 members; a
    ``CongestionReplay`` of 8 grids of side 128 with a dropout and a
    straggler, and one with a dropout and on-disk checkpoints
    (``CheckpointManager``), each bitwise a fault-free replay;
    ``[serve]``: ``SSSPService`` on gnp 2^20 through "pallas" (8
    landmarks, the planner, bidirectional pairs, reselect 0.5), 3 waves
    of 96 scalar and 8 full-vector queries around two 1,024-edge
    ``apply_delta``s, per wave ms, queries/s, routes and host reads;
    every answer bitwise a cold segment solve of its graph version
    (pair-cache answers: real paths folding to their distance, within
    rtol 1e-4) and within rtol 1e-4 of scipy (in 6 worker processes);
    ``[launch]``: ``serve_sssp.main`` on grid n = 2^14 with ``--verify``,
    landmarks and a delta (B2 launched), then ``--bidirectional`` (B1);
    ``[baselines]``: Bellman-Ford and Δ-stepping (0.25, 1.0) from the
    main path's first source on both 2^20 graphs, bitwise its SP4 dist;
    ``[distributed]``: ``Solver(backend="distributed")`` on gnp 2^20 at
    world 1 (a one-rank NCCL group, under torch's sync debug mode) and
    worlds 2 and 4 (gloo ranks spawned on the one card), ``solve`` and
    ``solve_batch(8)`` bitwise the main path's segment results, every
    rank bitwise every other, ``1 + c_prop_iters`` all-reduces a round
    (their ms and bytes logged); at world 2 also ``[dynamic]``'s gnp
    update and a grid of side 256;
    ``[legacy]``: ``run_sssp`` and ``run_sssp_ell`` bitwise the main
    path's gnp segment and pallas ``solve`` (B3 three times a round, B4
    once), ``run_sssp_traced`` on gnp 2^14 and a grid of side 128 with
    the bounds invariants checked every round and the card's trace
    bitwise the CPU's;
    ``[parity]``: the card bitwise against the port's own CPU run on
    2^12-vertex graphs of the seven generator families (cold batch, warm
    update with its stats, seeded targeted batch;
    bidirectional pairs and a 3-member fleet, cold and updated, on both
    routes), a planned service on the grid (frontier) and gnp (pallas), two waves
    around a delta, and the baselines on gnp, the card's runs under
    torch's sync debug mode, the CPU's in 3 worker processes beside them;
 6. xDeepFM scoring at the paper's FULL config (18.9 M table rows)
    through ``repro_torch.models.xdeepfm.XDeepFM``: the ``serve_p99``
    (B = 512), ``serve_bulk`` (B = 262,144) and ``retrieval_cand`` (1
    query, 10^6 candidates) workloads, timed, 3 CIN launches a forward,
    checked against the port's CPU forward and against smaller batches,
    and each CIN layer of the forwards against its plain version in
    float64;
 7. attention entry point: one ``ops.flash_attention`` call at a
    qwen3-32b layer's shape, its launches counted;
 8. ``[lm]``, LM serving through ``repro_torch.runtime.serve_loop.
    BatchServer`` (batched prefill, then decode steps): qwen3-32b at full
    width (d 5,120, 64/8 heads, hd 128, d_ff 25,600, vocab 151,936, bf16)
    cut to 4 layers, 8 prompts of 1,024 tokens, 32 greedy tokens; then
    deepseek-moe-16b at full width cut to 2 layers, 4 prompts of 256, 8
    tokens (the MoE dispatch on the card).  Each served twice, counted
    (one B6 launch a layer a prefill, the plain attention never called;
    the same tokens both times), its prefill and decode-step times logged
    beside their bounds (``lm_work``); B6 held against its plain version
    on the prefill's own layer-0 q/k/v (bf16 tolerance; the kernel phase
    times B6 at that shape); the batched prefill's logits and cache
    against S decode steps of the same prompts (``PREFILL_TOL``; MoE
    routing flips excused on at most ``FLIP_SHARE`` of a layer's
    tokens).  The qwen3, deepseek and llama4 smoke configs in f32, card
    against the port's CPU run: greedy tokens equal, prefill logits
    within 2e-3.  Then the ``serve`` launcher's ``main`` on the card.
 9. ``[train]``, training through ``repro_torch.runtime.train_loop.
    Trainer`` (AdamW, clipping, warmup-cosine): qwen3-32b at full width
    cut to 4 layers, 5 steps on ``TokenStream`` B 4 x 1,024, and
    deepseek-moe-16b at full width cut to 2 layers, 3 steps of B 4 x 512
    (the router moves), every step counted (one B6 forward with lse and
    one B6 backward a layer), step ms, tokens/s and peak GiB against
    ``train_work``'s bound; the FULL xDeepFM (uncut table) at its
    ``train_batch`` of 65,536, 3 steps, CIN launches a step pinned
    (``cin.backward_launches``), rows/s; the SMOKE xDeepFM's 60 SGD
    steps (the loss falls); the five LM smoke configs in f32, loss and
    gradients card against CPU (2e-3); the ``train`` launcher, and its
    xDeepFM run resumed from its checkpoints.

Each phase prints its wall time.

The line before the last is the kernels' JSON record, one entry a kernel
with each timed shape under ``shapes`` (and, for the split-f32 kernels,
their three-product tensor-core bound); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository, the script exits non-zero before printing either.
"""
from __future__ import annotations

import argparse
import collections
import copy
import functools
import hashlib
import itertools
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory, NVIDIA data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 on the tensor cores
TF32_OPS_PER_S = 495e12       # H100 SXM dense TF32 on the tensor cores
REPS = 25
DEVICE = "cuda"
GRID_SIDE = 1024              # grid(side=1024): n = 2^20, 4.2 M edges
GNP_N = 1 << 20               # gnp(2^20, avg_deg=8): 8.4 M edges
FRONTIER_CAP = 4096           # the Solver's default cap at n = 2^20
PARITY_N = 1 << 12            # card vs CPU parity graphs (sized for the
#   script's time limit: its runs are host-bound, ~linear in rounds;
#   2^13 took 124.2-172.2 s)
PARITY_HUB_N = 1 << 9         # power_law's frontier fleet (see fleet_parity)
FLEET_SIDE = 256              # [fleet]: 8 grids, n = 2^16 each (sized for
#   the script's time limit: side 512 took ~150 s of the script's time)
REPLAY_SIDE = 128             # [fleet] congestion replay: 8 grids, n = 2^14
# a landmark seed is a difference of two f32 path sums, each of which may
# be off by about (hops x 6e-8) of its value: a seed may pass the f32
# distance by that much, held to 1e-4 of the largest finite table entry
SEED_TOL = 1e-4
CIN_SHAPE = dict(B=512, M=39, D=10, K=200)    # serve_p99, paper widths
# one qwen3-32b attention layer: 64 query heads, 8 KV heads, head_dim 128
ATTN_SHAPE = dict(B=1, H=64, H_KV=8, S=4096, d=128)
# the same layer as [lm]'s qwen3-32b prefill gives it to B6 (LM_SHAPE)
LM_ATTN_SHAPE = dict(B=8, H=64, H_KV=8, S=1024, d=128)
# attention against its plain version: the reference's f32 tolerance; in
# bf16 two bf16 steps (the outputs differ only in rounding of the f32
# result), inside the reference's 2e-2
ATTN_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
            "bfloat16": dict(rtol=1.6e-2, atol=4e-3)}


def log(*a):
    print(*a, flush=True)


def graph_arrays(pt, name: str):
    """The host arrays ``(n, src, dst, w)`` of the main path's graphs,
    generated once a run (kept in ``pt``): "grid" (side 1024) and "gnp"
    (2^20, average degree 8), weights from seed 0."""
    arrays = pt.setdefault("arrays", {})
    if name not in arrays:
        gen = pt["generators"]
        arrays[name] = (gen.grid(GRID_SIDE, seed=0) if name == "grid"
                        else gen.gnp(GNP_N, avg_deg=8.0, seed=0))
    return arrays[name]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def device_profile(torch, fn, reps: int = REPS):
    """Device time of one ``fn()`` and the device operations it runs: the
    kernels' (and fills' and copies') own time and count summed over
    ``reps`` runs by ``torch.profiler`` (CUPTI), divided by ``reps``.
    Unlike the event time it leaves out the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = _device_events(prof)
    return (sum(_self_device_us(e) for e in ev) / reps / 1e3,
            sum(e.count for e in ev) / reps)


def device_ms(torch, fn, reps: int = REPS) -> float:
    """Device time of one ``fn()`` (``device_profile``)."""
    return device_profile(torch, fn, reps)[0]


def _device_events(prof):
    return [e for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))]


def _self_device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def max_abs_err(torch, got, want) -> float:
    """0.0 iff bitwise equal; inf where +inf positions differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    if torch.equal(got, want):
        return 0.0
    g, w = got.double(), want.double()
    fin = torch.isfinite(g) & torch.isfinite(w)
    if not torch.equal(torch.isinf(g), torch.isinf(w)):
        return float("inf")
    return float((g[fin] - w[fin]).abs().max()) if fin.any() else 0.0


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(rec, name, shape, ms, plain, lib, dev, b_ms, b_by, **extra):
    """One timed shape of a kernel, appended to its ``shapes``: event and
    device times of the kernel, its plain version and the library call,
    and the bound.  The kernel's own keys take the shape timed last, the
    main path's (B = 8, CIN layer 2, bf16 attention at the shape of the
    ``[lm]`` qwen3-32b prefill's layer)."""
    r = rec.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
    r["shapes"].append(dict(
        shape=shape, ms=ms, device_ms=dev["kernel"], plain_ms=plain,
        plain_device_ms=dev["plain"], library_ms=lib,
        library_device_ms=dev.get("library"), bound_ms=b_ms, bound_by=b_by,
        **extra))
    r.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
             library_ms=lib)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def frontier_inputs(torch, g, B: int, cap: int, seed: int):
    """x, src_mask and a frontier buffer of ``cap`` distinct vertices (no
    padding: a full, non-overflow buffer) on the graph ``g``."""
    rng = np.random.default_rng(seed)
    dev = g.device
    f_idx = torch.from_numpy(np.sort(rng.choice(g.n, cap, replace=False))
                             .astype(np.int32)).to(dev)
    x = torch.from_numpy(rng.uniform(0, 50, (B, g.n)).astype(np.float32)
                         ).to(dev)
    mask = torch.from_numpy(rng.random((B, g.n)) < 0.7).to(dev)
    return x, mask, f_idx


def gather_tgt_cand(torch, ref, csr, x, mask, f_idx):
    """The tgt/cand table of the shared-frontier relax, built by the
    PyTorch gather ``ops.frontier_relax_b`` ran around the tgt/cand
    kernel before the gather was fused into the kernel."""
    n = csr.n
    u, cell, epos = ref.out_cells(csr.indptr, f_idx, csr.max_out_deg,
                                  csr.e_pad)
    tgt = torch.where(cell, csr.dst[epos], n).to(torch.int32)
    w = csr.w[epos]
    lane_ok = cell[None] & mask[:, u][:, :, None]
    cand = torch.where(lane_ok, x[:, u][:, :, None] + w[None], float("inf"))
    return tgt.contiguous(), cand.contiguous()


def kernel_phase(torch, pt):
    from repro_torch.core.graph import ell_row_len
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.frontier_relax import (
        frontier_relax_csr, frontier_scatter_min, frontier_scatter_min_batch)
    from repro_torch.kernels.relax import relax_ell, xm_stride
    from repro_torch.kernels.segment_min import masked_min, masked_min_pair
    sssp = pt["sssp"]
    dev = torch.device(DEVICE)
    rec = {}
    inf = float("inf")

    def held(name, got, want, what):
        err = max_abs_err(torch, got, want)
        log(f"  {name:28s} {what:44s} max_abs_err={err}")
        check(err == 0.0, f"{name} disagrees with its plain version "
                          f"({what}): max_abs_err={err}")
        r = rec.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def b1_op(x0, m0, f_idx, want, what, plain, plain_dev, b_ms, b_by):
        """``ops.frontier_relax`` (launch key ``frontier_relax``) held
        against its plain version, timed, recorded under B1's row."""
        def op1():
            return ops.frontier_relax(x0, csr, f_idx, m0)
        held("frontier_relax", op1(), want, f"B=1 {what} (B1 op)")
        o_ms = time_ms(torch, op1)
        o_dev, o_ops = device_profile(torch, op1)
        log(f"  ops.frontier_relax {what} (B1 op): {o_ms:.4f} ms (events), "
            f"device {o_dev:.4f} ms, plain {plain:.4f} / {plain_dev:.4f} "
            f"ms, {o_ops:.1f} device ops a call; wrapper host cost "
            f"{o_ms - o_dev:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
        record(rec, "frontier_relax", what, o_ms, plain, None,
               dict(kernel=o_dev, plain=plain_dev), b_ms, b_by,
               device_ops=o_ops)

    # --- B2 / B1 at the grid-1024 frontier shapes ----------------------
    n, src, dst, w = graph_arrays(pt, "grid")
    g = sssp.build_graph(n, src, dst, w, device=dev)
    csr = g.csr()
    cap = FRONTIER_CAP
    log(f"[kernels] grid side 1024: n={g.n} e={g.e} cap={cap} "
        f"max_out_deg={csr.max_out_deg}")
    for B in (1, 8):
        x, mask, f_idx = frontier_inputs(torch, g, B, cap, seed=B)
        args = (x, mask, f_idx, csr.indptr, csr.dst, csr.w, csr.max_out_deg)
        want = ref.frontier_relax_ref(*args)
        held("frontier_relax_csr", frontier_relax_csr(*args), want,
             f"B={B} cap {cap} x {csr.max_out_deg}")
        # timed as the engine calls it; beside it the unfused form: the
        # PyTorch gather, then the tgt/cand kernel
        fused = lambda: ops.frontier_relax_b(x, csr, f_idx, mask)  # noqa: E731
        held("frontier_relax_csr", fused(), want,
             f"B={B} ops.frontier_relax_b")

        def unfused():
            tgt, cand = gather_tgt_cand(torch, ref, csr, x, mask, f_idx)
            return frontier_scatter_min_batch(tgt, cand, g.n)
        ms = time_ms(torch, fused)
        plain = time_ms(torch, lambda: ref.frontier_relax_ref(*args))
        un_ms = time_ms(torch, unfused)
        k_dev, k_ops = device_profile(torch, fused)
        p_dev, _ = device_profile(torch, lambda: ref.frontier_relax_ref(*args))
        u_dev, u_ops = device_profile(torch, unfused)
        dt = dict(kernel=k_dev, plain=p_dev)
        slot_deg = csr.indptr[f_idx.long() + 1] - csr.indptr[f_idx.long()]
        live = int(slot_deg.sum())
        b_ms, b_by = bound(12 * cap + 8 * live + 5 * B * cap + 4 * B * g.n,
                           B * live)
        b_ms_fused, b_by_fused, plain_fused = b_ms, b_by, plain
        log(f"  frontier_relax_csr B={B} (ops.frontier_relax_b): fused "
            f"{ms:.4f} ms, plain {plain:.4f} ms, gather + tgt/cand kernel "
            f"{un_ms:.4f} ms (events); device {k_dev:.4f} / {p_dev:.4f} / "
            f"{u_dev:.4f} ms; device ops a call {k_ops:.1f} fused, "
            f"{u_ops:.1f} gather + kernel; wrapper host cost "
            f"{ms - k_dev:.4f} ms; {live} live cells; bound {b_ms:.4f} ms "
            f"({b_by})")
        record(rec, "frontier_relax_csr", f"B={B}", ms, plain, None, dt,
               b_ms, b_by, device_ops=k_ops, unfused_ms=un_ms,
               unfused_device_ms=u_dev, unfused_device_ops=u_ops)

        # the tgt/cand entry at the TPU kernel's signature; its library
        # column is the same function: an +inf fill and scatter_reduce_
        tgt, cand = gather_tgt_cand(torch, ref, csr, x, mask, f_idx)
        got = frontier_scatter_min_batch(tgt, cand, g.n)
        want2 = ref.frontier_scatter_min_batch_ref(tgt, cand, g.n)
        held("frontier_scatter_min_batch", got, want2,
             f"B={B} tgt{tuple(tgt.shape)}")
        check(torch.equal(want2, want), "the tgt/cand and fused plain "
                                        "versions disagree")
        idx = torch.where((tgt >= 0) & (tgt < g.n), tgt.long(), g.n
                          ).reshape(1, -1).expand(B, -1)
        vals = cand.reshape(B, -1)

        def library(rows=B):
            out = torch.full((rows, g.n + 1), inf, device=dev)
            return out.scatter_reduce_(1, idx[:rows], vals[:rows], "amin")
        check(torch.equal(library()[:, :g.n], want2), "full + "
              "scatter_reduce_ yardstick disagrees with the plain version")
        kern = lambda: frontier_scatter_min_batch(tgt, cand, g.n)  # noqa: E731
        ms = time_ms(torch, kern)
        plain = time_ms(torch, lambda: ref.frontier_scatter_min_batch_ref(
            tgt, cand, g.n))
        lib = time_ms(torch, library)
        k_dev, k_ops = device_profile(torch, kern)
        dt = dict(kernel=k_dev,
                  plain=device_ms(torch, lambda: ref.
                                  frontier_scatter_min_batch_ref(
                                      tgt, cand, g.n)),
                  library=device_ms(torch, library))
        cells = tgt.numel()
        b_ms, b_by = bound(4 * cells + 4 * B * cells + 4 * B * g.n,
                           B * cells)
        log(f"  frontier_scatter_min_batch B={B}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, full + scatter_reduce_ {lib:.4f} ms "
            f"(events); device {dt['kernel']:.4f} / {dt['plain']:.4f} / "
            f"{dt['library']:.4f} ms; {k_ops:.1f} device ops a call; "
            f"bound {b_ms:.4f} ms ({b_by})")
        record(rec, "frontier_scatter_min_batch", f"B={B}", ms, plain, lib,
               dt, b_ms, b_by, device_ops=k_ops)
        if B == 1:
            # B1's single-lane op, the legacy round's: the fused entry at
            # B = 1 under its own launch key, here and at the
            # bidirectional route's cap 2^20 below
            x0, m0 = x[0].contiguous(), mask[0].contiguous()
            b1_op(x0, m0, f_idx, want[0], f"cap {cap}", plain_fused,
                  p_dev, b_ms_fused, b_by_fused)
            c0 = cand[0].contiguous()
            held("frontier_scatter_min", frontier_scatter_min(tgt, c0, g.n),
                 want[0], "B=1 (B1 wrapper)")
            def k1():
                return frontier_scatter_min(tgt, c0, g.n)

            def p1():
                return ref.frontier_scatter_min_ref(tgt, c0, g.n)
            ms1, pl1, lib1 = (time_ms(torch, k1), time_ms(torch, p1),
                              time_ms(torch, lambda: library(1)))
            d1, d1_ops = device_profile(torch, k1)
            dt1 = dict(kernel=d1, plain=device_ms(torch, p1),
                       library=device_ms(torch, lambda: library(1)))
            log(f"  frontier_scatter_min B=1: kernel {ms1:.4f} ms, plain "
                f"{pl1:.4f} ms, full + scatter_reduce_ {lib1:.4f} ms "
                f"(events); device {dt1['kernel']:.4f} / {dt1['plain']:.4f} "
                f"/ {dt1['library']:.4f} ms; {d1_ops:.1f} device ops a call; "
                f"wrapper host cost {ms1 - d1:.4f} ms")
            record(rec, "frontier_scatter_min", "B=1", ms1, pl1, lib1, dt1,
                   b_ms, b_by, device_ops=d1_ops)
    # B1 at the bidirectional frontier route's buffer, cap = next_pow2(n)
    # = 2^20: a wavefront of 4,096 live slots (sorted), then padding n
    big = 1 << (g.n - 1).bit_length()
    x1, m1, f_live = frontier_inputs(torch, g, 1, FRONTIER_CAP, seed=21)
    f_big = torch.full((big,), g.n, dtype=torch.int32, device=dev)
    f_big[:FRONTIER_CAP] = f_live
    x1, m1 = x1[0].contiguous(), m1[0].contiguous()
    a_big = (x1[None], m1[None], f_big, csr.indptr, csr.dst, csr.w,
             csr.max_out_deg)
    want_big = ref.frontier_relax_ref(*a_big)[0]
    plain_big = time_ms(torch, lambda: ref.frontier_relax_ref(*a_big))
    plain_big_dev = device_ms(torch, lambda: ref.frontier_relax_ref(*a_big))
    live_deg = csr.indptr[f_live.long() + 1] - csr.indptr[f_live.long()]
    cells = int(live_deg.sum())
    # the kernel reads every buffer slot, indptr twice and x and the mask
    # once a live slot, dst and w a live cell, and writes the +inf-filled
    # output once
    b_ms, b_by = bound(4 * big + 13 * FRONTIER_CAP + 8 * cells + 4 * g.n,
                       cells)
    b1_op(x1, m1, f_big, want_big, f"cap 2^20 ({FRONTIER_CAP} live)",
          plain_big, plain_big_dev, b_ms, b_by)
    del f_big, a_big, want_big

    # fused edge cases: an all-padding buffer; n=1001 with a partial and a
    # full buffer (every vertex, then padding) and duplicate targets
    x2, m2, _ = frontier_inputs(torch, g, 2, cap, seed=3)
    f_pad = torch.full((cap,), g.n, dtype=torch.int32, device=dev)
    a_pad = (x2, m2, f_pad, csr.indptr, csr.dst, csr.w, csr.max_out_deg)
    held("frontier_relax_csr", frontier_relax_csr(*a_pad),
         ref.frontier_relax_ref(*a_pad), "all-padding buffer")
    rng = np.random.default_rng(11)
    s_src, s_dst = rng.integers(0, 1001, 6000), rng.integers(0, 1001, 6000)
    keep = s_src != s_dst
    small_g = sssp.build_graph(1001, s_src[keep], s_dst[keep],
                               rng.uniform(0.05, 1, keep.sum()), device=dev)
    sc = small_g.csr()
    x3, m3, _ = frontier_inputs(torch, small_g, 3, 8, seed=4)
    for what, f in (("partial", np.concatenate([np.sort(rng.choice(
            1001, 300, replace=False)), np.full(212, 1001)])),
            ("full", np.concatenate([np.arange(1001), np.full(23, 1001)]))):
        f3 = torch.from_numpy(f.astype(np.int32)).to(dev)
        a3 = (x3, m3, f3, sc.indptr, sc.dst, sc.w, sc.max_out_deg)
        held("frontier_relax_csr", frontier_relax_csr(*a3),
             ref.frontier_relax_ref(*a3), f"n=1001 B=3 {what} buffer")
        held("frontier_relax", ops.frontier_relax(
            x3[0].contiguous(), sc, f3, m3[0].contiguous()),
            ref.frontier_relax_ref(*a3)[0], f"n=1001 {what} (B1 op)")
    # tgt/cand edge cases: all padding, all +inf, n not a multiple of the
    # block
    tgt_pad = torch.full((cap, 4), g.n, dtype=torch.int32, device=dev)
    c_any = torch.rand((2, cap, 4), device=dev)
    held("frontier_scatter_min_batch",
         frontier_scatter_min_batch(tgt_pad, c_any, g.n),
         ref.frontier_scatter_min_batch_ref(tgt_pad, c_any, g.n),
         "all-padding targets")
    t_rand = torch.randint(0, 1001, (37, 5), dtype=torch.int32, device=dev)
    c_inf = torch.full((3, 37, 5), inf, device=dev)
    held("frontier_scatter_min_batch",
         frontier_scatter_min_batch(t_rand, c_inf, 1001),
         ref.frontier_scatter_min_batch_ref(t_rand, c_inf, 1001),
         "all +inf candidates, n=1001")
    c_odd = torch.rand((3, 37, 5), device=dev) * 7
    held("frontier_scatter_min_batch",
         frontier_scatter_min_batch(t_rand, c_odd, 1001),
         ref.frontier_scatter_min_batch_ref(t_rand, c_odd, 1001),
         "n=1001 with duplicate targets")
    # the premise: negatives order backwards as int32 bit patterns
    t_neg = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    c_neg = torch.tensor([[[-1.0], [-2.0]]], device=dev)
    k_neg = frontier_scatter_min_batch(t_neg, c_neg, 3)[0, 0].item()
    p_neg = ref.frontier_scatter_min_batch_ref(t_neg, c_neg, 3)[0, 0].item()
    log(f"  premise: candidates -1.0 and -2.0 at one target give "
        f"kernel {k_neg}, plain {p_neg} (the engine makes no negatives)")
    if dev.type == "cuda":
        check(p_neg == -2.0 and k_neg == -1.0,
              "negative-input behaviour of the scatter-min kernel changed")
    del g, csr

    def relax_timed(what, ell, B, seed):
        """B3 at one shape: held against the plain version, timed as the
        engine calls it and over full rows (row_len = deg_pad), with the
        live-cell bound (the function's), the same plus the round trip of
        the kernel's packed lanes, and the padded-layout bound."""
        n = ell.n
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.uniform(0, 50, (B, n)).astype(np.float32)
                             ).to(dev)
        x[torch.from_numpy(rng.random((B, n)) < 0.3).to(dev)] = inf
        mask = torch.from_numpy(rng.random((B, n)) < 0.5).to(dev)
        arrays = (ell.in_src, ell.in_w, n)
        want = ref.relax_ell_ref(x, mask, *arrays)
        whole = torch.full_like(ell.row_len, ell.deg_pad)
        kern = lambda: relax_ell(x, mask, *arrays, ell.row_len)  # noqa: E731
        full = lambda: relax_ell(x, mask, *arrays, whole)  # noqa: E731
        shape = f"{what} B={B} [{ell.n_pad}, {ell.deg_pad}]"
        held("relax_ell", kern(), want, shape)
        held("relax_ell", full(), want, f"{what} B={B} full rows")
        ms = time_ms(torch, kern)
        plain = time_ms(torch, lambda: ref.relax_ell_ref(x, mask, *arrays),
                        reps=5, warmup=1)
        dt = dict(kernel=device_ms(torch, kern), plain=device_ms(
            torch, lambda: ref.relax_ell_ref(x, mask, *arrays), reps=5))
        f_dev = device_ms(torch, full)
        live = int((ell.in_src[:n] < n).sum())
        live_bytes = 8 * live + 4 * n + 5 * B * n + 4 * B * n
        b_ms, b_by = bound(live_bytes, 2 * B * live)
        xm_bytes = 8 * n * xm_stride(B)
        packed_ms = (live_bytes + xm_bytes) / HBM_BYTES_PER_S * 1e3
        pad_ms, pad_by = bound(8 * n * ell.deg_pad + 9 * B * n,
                               2 * B * n * ell.deg_pad)
        log(f"  relax_ell {what} B={B}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms (events); device {dt['kernel']:.4f} / "
            f"{dt['plain']:.4f} ms; full rows {f_dev:.4f} ms (device); "
            f"{live} live cells; bounds: live-cell {b_ms:.4f} ms ({b_by}), "
            f"with the kernel's packed lanes {packed_ms:.4f} ms, padded "
            f"layout {pad_ms:.4f} ms ({pad_by})")
        record(rec, "relax_ell", f"{what} B={B}", ms, plain, None, dt, b_ms,
               b_by, packed_bound_ms=packed_ms, padded_bound_ms=pad_ms,
               full_rows_device_ms=f_dev)
        return x, mask

    # --- B3 on the grid side-1024 ELL ----------------------------------
    ell = sssp.build_ell(n, src, dst, w, device=dev)
    log(f"[kernels] grid ELL n_pad={ell.n_pad} deg_pad={ell.deg_pad}")
    relax_timed("grid", ell, 1, seed=5)
    del ell

    def b4_timed(x, mask, add):
        """B4 at one shape, the single form and the pair on ``add``: held
        before and after the timed calls (each call leaves the kernel's
        tickets at 0 for the next), timed with the plain versions and
        the library calls (``torch.masked.amin``, twice for the pair)."""
        B, n = x.shape
        amin = torch.masked.amin
        forms = (
            ("masked_min", lambda: masked_min(x, mask),
             lambda: ref.masked_min_ref(x, mask),
             lambda: amin(x, 1, mask=mask), "torch.masked.amin",
             5 * B * n + 4 * B, B * n),
            ("masked_min_pair", lambda: masked_min_pair(x, mask, add),
             lambda: ref.masked_min_pair_ref(x, mask, add),
             lambda: (amin(x, 1, mask=mask), amin(x + add, 1, mask=mask)),
             "torch.masked.amin x2", 5 * B * n + 4 * n + 8 * B, 3 * B * n))
        for name, kern, plain_fn, lib_fn, lib_name, nbytes, nops in forms:
            want = plain_fn()
            held(name, kern(), want, f"gnp B={B} n={n}")
            lib_out = lib_fn()
            if isinstance(lib_out, tuple):
                lib_out = torch.stack(lib_out, dim=1)
            check(torch.equal(lib_out, want), f"{lib_name} disagrees with "
                                              f"{name}'s plain version")
            ms = time_ms(torch, kern)
            plain = time_ms(torch, plain_fn)
            lib = time_ms(torch, lib_fn)
            k_dev, k_ops = device_profile(torch, kern)
            dt = dict(kernel=k_dev, plain=device_ms(torch, plain_fn),
                      library=device_ms(torch, lib_fn))
            held(name, kern(), want, f"gnp B={B} after the timed calls")
            b_ms, b_by = bound(nbytes, nops)
            log(f"  {name} B={B}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"{lib_name} {lib:.4f} ms (events); device {k_dev:.4f} / "
                f"{dt['plain']:.4f} / {dt['library']:.4f} ms; {k_ops:.1f} "
                f"device ops a call; wrapper host cost {ms - k_dev:.4f} ms; "
                f"bound {b_ms:.4f} ms ({b_by})")
            record(rec, name, f"B={B}", ms, plain, lib, dt, b_ms, b_by,
                   device_ops=k_ops)

    # --- B3 / B4 at the gnp 2^20 ELL shapes ----------------------------
    n, src, dst, w = graph_arrays(pt, "gnp")
    ell = sssp.build_ell(n, src, dst, w, device=dev)
    out_w = sssp.build_graph(n, src, dst, w, device=dev).out_weight
    log(f"[kernels] gnp n={n} e={len(src)} ELL n_pad={ell.n_pad} "
        f"deg_pad={ell.deg_pad}; B4's add is the graph's outWeight "
        f"({int(torch.isinf(out_w).sum())} +inf cells)")
    for B in (1, 8):
        x, mask = relax_timed("gnp", ell, B, seed=7 + B)
        zeros = torch.zeros_like(x)
        held("relax_ell", relax_ell(None, mask, ell.in_src, ell.in_w, n,
                                    ell.row_len),
             ref.relax_ell_ref(zeros, mask, ell.in_src, ell.in_w, n),
             f"gnp B={B} x=None (inWeight_nf)")
        b4_timed(x, mask, out_w)
    x3 = torch.rand((3, n), device=dev) * 9
    m3 = torch.rand((3, n), device=dev) < 0.5
    held("relax_ell", relax_ell(x3, m3, ell.in_src, ell.in_w, n, ell.row_len),
         ref.relax_ell_ref(x3, m3, ell.in_src, ell.in_w, n),
         "gnp B=3 (a ragged lane group)")
    del ell, out_w
    # edge cases: empty masks, all-padding ELL rows, odd n, a table with
    # holes and a row longer than a thread group
    x = torch.rand((3, 1001), device=dev) * 9
    none = torch.zeros((3, 1001), dtype=torch.bool, device=dev)
    some = torch.rand((3, 1001), device=dev) < 0.4
    some[1] = False
    held("masked_min", masked_min(x, none), ref.masked_min_ref(x, none),
         "empty masks, n=1001")
    held("masked_min", masked_min(x, some), ref.masked_min_ref(x, some),
         "one empty lane, n=1001")
    add = torch.rand(1001, device=dev) * 3
    add[::7] = inf
    for what, a in (("add with +inf cells", add),
                    ("add all +inf", torch.full_like(add, inf)),
                    ("add None", None)):
        held("masked_min_pair", masked_min_pair(x, some, a),
             ref.masked_min_pair_ref(x, some, a),
             f"n=1001 B=3, one empty lane, {what}")
    held("masked_min_pair", masked_min_pair(x, none, add),
         ref.masked_min_pair_ref(x, none, add), "empty masks, n=1001")
    # several blocks a lane, at n % 4 = 3 (each row starts at its own
    # alignment; the pair's rows after the first are scalar), with x,
    # mask and add one element into their storage (a scalar head, then
    # float4 groups), and with x alone one element in (all scalar)
    for n_b4, sx, sr in ((100_003, 0, 0), (100_000, 1, 1),
                         (100_000, 1, 0)):
        xs = (torch.rand(3 * n_b4 + sx, device=dev) * 9)[sx:].view(3, n_b4)
        mk = (torch.rand(3 * n_b4 + sr, device=dev) < 0.3)[sr:].view(3, n_b4)
        ad = (torch.rand(n_b4 + sr, device=dev) * 3)[sr:]
        ad[::5] = inf
        what = f"n={n_b4} B=3, shifted by x {sx}, mask and add {sr}"
        held("masked_min", masked_min(xs, mk), ref.masked_min_ref(xs, mk),
             what)
        held("masked_min_pair", masked_min_pair(xs, mk, ad),
             ref.masked_min_pair_ref(xs, mk, ad), what)
    s_src = rng.integers(0, 1001, 4000)
    s_dst = rng.integers(0, 1001, 4000)
    keep = (s_src != s_dst) & (s_dst % 7 != 0)      # rows d%7==0: padding
    small = sssp.build_ell(1001, s_src[keep], s_dst[keep],
                           rng.uniform(0.05, 1, keep.sum()), device=dev)
    for lanes in (3, 1):
        xs, mk = x[:lanes].contiguous(), some[:lanes].contiguous()
        held("relax_ell", relax_ell(xs, mk, small.in_src, small.in_w, 1001,
                                    small.row_len),
             ref.relax_ell_ref(xs, mk, small.in_src, small.in_w, 1001),
             f"n=1001 B={lanes}, empty lane, all-padding rows")
    held("relax_ell", relax_ell(x, none, small.in_src, small.in_w, 1001,
                                torch.full_like(small.row_len, small.deg_pad)),
         ref.relax_ell_ref(x, none, small.in_src, small.in_w, 1001),
         "n=1001, empty masks, full rows")
    try:
        relax_ell(x, some, small.in_src, small.in_w, 1001)
        fail("relax_ell launched on the card without row_len")
    except ValueError:
        log("  relax_ell without row_len on the card: ValueError, as meant")
    holes_src = np.full((1008, 128), 1001, np.int32)
    holes_w = np.full((1008, 128), inf, np.float32)
    for i in range(0, 1001, 3):
        k = 19 if i % 2 else int(rng.integers(1, 6))   # > 8: several steps
        cols = np.sort(rng.choice(128, k, replace=False))
        holes_src[i, cols] = rng.integers(0, 1001, k)
        holes_w[i, cols] = rng.uniform(0.05, 1, k)
    h_len = torch.from_numpy(ell_row_len(holes_src, 1001)).to(dev)
    h_src = torch.from_numpy(holes_src).to(dev)
    h_w = torch.from_numpy(holes_w).to(dev)
    for lanes in (1, 3):
        xs, mk = x[:lanes].contiguous(), some[:lanes].contiguous()
        held("relax_ell", relax_ell(xs, mk, h_src, h_w, 1001, h_len),
             ref.relax_ell_ref(xs, mk, h_src, h_w, 1001),
             f"n=1001 B={lanes}, holes, rows of 19 live cells")
        held("relax_ell", relax_ell(None, mk, h_src, h_w, 1001, h_len),
             ref.relax_ell_ref(torch.zeros_like(xs), mk, h_src, h_w, 1001),
             f"n=1001 B={lanes}, holes, x=None")
    torch.cuda.synchronize()
    return rec


def attn_inputs(torch, dtype, seed: int = 0, a=ATTN_SHAPE):
    """q [B, 64, S, 128] and k, v drawn for 8 KV heads and repeated to 64,
    as a grouped-query caller hands them to ``ops.flash_attention``."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    rep = a["H"] // a["H_KV"]

    def draw(heads):
        return torch.randn((a["B"], heads, a["S"], a["d"]), generator=g,
                           device=DEVICE).to(dtype)
    q = draw(a["H"])
    k = draw(a["H_KV"]).repeat_interleave(rep, dim=1)
    v = draw(a["H_KV"]).repeat_interleave(rep, dim=1)
    return q, k, v


def held_rec(torch, rec, name, got, want, rtol, atol, what):
    """``got`` allclose ``want`` (logged, and failing the run if not);
    the error joins kernel ``name``'s ``max_abs_err`` in ``rec``."""
    err = max_abs_err(torch, got.float(), want.float())
    ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    log(f"  {name:16s} {what:44s} max_abs_err={err:.3e} "
        f"(rtol {rtol:g}, atol {atol:g}: {'ok' if ok else 'FAILED'})")
    check(ok, f"{name} disagrees with its plain version ({what})")
    r = rec.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    return err


def timed_rec(torch, rec, name, what, err, kern, plain, lib, lib_name,
              nbytes, nops, ops_per_s=FP32_OPS_PER_S, peak_name="f32",
              tc_ops_per_s=None, plain_reps=5):
    """Event and device times of ``kern``, ``plain`` and ``lib`` (the
    library call) and the bound, logged and recorded for ``name``.
    ``tc_ops_per_s``: the tensor-core rate of a split-f32 kernel, which
    takes three products for each f32 product."""
    ms = time_ms(torch, kern)
    pl = time_ms(torch, plain, reps=plain_reps, warmup=1)
    lb = time_ms(torch, lib, reps=5, warmup=1)
    dt = dict(kernel=device_ms(torch, kern),
              plain=device_ms(torch, plain, reps=plain_reps),
              library=device_ms(torch, lib, reps=5))
    b_ms, b_by = bound(nbytes, nops, ops_per_s)
    extra = dict(max_abs_err=err)
    tc = ""
    if tc_ops_per_s:
        extra["tensor_core_bound_ms"] = 3 * nops / tc_ops_per_s * 1e3
        tc = (f", 3-product tensor-core bound "
              f"{extra['tensor_core_bound_ms']:.4f} ms")
    log(f"  {name} {what}: kernel {ms:.4f} ms, plain {pl:.4f} ms, "
        f"{lib_name} {lb:.4f} ms (events); device {dt['kernel']:.4f} / "
        f"{dt['plain']:.4f} / {dt['library']:.4f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}, {peak_name} peak){tc}; "
        f"{nops / ms / 1e9:.2f} TFLOP/s; device time / {lib_name}'s "
        f"{dt['kernel'] / dt['library'] if dt['library'] else 0:.3f}")
    record(rec, name, what, ms, pl, lb, dt, b_ms, b_by, **extra)


def model_kernel_phase(torch, rec):
    """B5 and B6 against their plain versions at the main paths' shapes.

    B5 is held against its plain version evaluated in float64 (rounded to
    float32): in float32 the plain version's cuBLAS GEMM sums the H*M =
    7,800 products of a layer-2 output in one long sequence and strays
    further from the exact value than the kernel does; both errors are
    printed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cin import cin_layer
    from repro_torch.kernels.flash_attn import flash_attention
    held = functools.partial(held_rec, torch, rec)
    timed = functools.partial(timed_rec, torch, rec)

    # --- B5 at serve_p99, CIN layers 1 (H = 39) and 2 (H = 200) ---------
    c = CIN_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(5)
    for H in (c["M"], 200):
        def draw(*shape):
            return torch.randn(shape, generator=g, device=DEVICE)
        xk, x0 = draw(c["B"], H, c["D"]), draw(c["B"], c["M"], c["D"])
        w = draw(c["K"], H, c["M"])
        what = f"B={c['B']} H={H} M={c['M']} D={c['D']} K={c['K']}"
        got = cin_layer(xk, x0, w)
        exact = ref.cin_layer_ref(xk.double(), x0.double(), w.double())
        plain32 = ref.cin_layer_ref(xk, x0, w)
        log(f"  cin_layer plain f32 vs f64 {what}: max_abs_err "
            f"{max_abs_err(torch, plain32, exact.float()):.3e}")
        err = held("cin_layer", got, exact.float(), 3e-4, 3e-4,
                   what + " vs f64")
        nops = 2.0 * c["K"] * H * c["M"] * c["D"] * c["B"]
        nbytes = 4 * (c["B"] * H * c["D"] + c["B"] * c["M"] * c["D"]
                      + c["K"] * H * c["M"] + c["B"] * c["K"] * c["D"])
        timed("cin_layer", what, err,
              lambda: cin_layer(xk, x0, w),
              lambda: ref.cin_layer_ref(xk, x0, w),
              lambda: torch.einsum("khm,bhd,bmd->bkd", w, xk, x0),
              "einsum", nbytes, nops, tc_ops_per_s=TF32_OPS_PER_S)
    for B, H, M, D, K in ((37, 7, 5, 3, 65), (1, 200, 39, 10, 200)):
        xk = torch.randn((B, H, D), generator=g, device=DEVICE)
        x0 = torch.randn((B, M, D), generator=g, device=DEVICE)
        w = torch.randn((K, H, M), generator=g, device=DEVICE)
        held("cin_layer", cin_layer(xk, x0, w), ref.cin_layer_ref(
            xk.double(), x0.double(), w.double()).float(), 3e-4, 3e-4,
            f"edge B={B} H={H} M={M} D={D} K={K} vs f64")

    # --- B6 at one qwen3-32b attention layer, bf16 and f32 ---------------
    a = ATTN_SHAPE
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nops = 2.0 * a["S"] ** 2 * a["d"] * a["H"] * a["B"]      # causal
    for dtype, peak, peak_name in (
            (torch.float32, FP32_OPS_PER_S, "f32"),
            (torch.bfloat16, BF16_OPS_PER_S, "dense bf16")):
        q, k, v = attn_inputs(torch, dtype)
        what = (f"{str(dtype)[6:]} B={a['B']} H={a['H']} S={a['S']} "
                f"d={a['d']} causal")
        err = held("flash_attention", flash_attention(q, k, v, causal=True),
                   ref.flash_attention_ref(q, k, v, causal=True),
                   **ATTN_TOL[str(dtype)[6:]], what=what)
        nbytes = 4 * q.numel() * q.element_size()
        timed("flash_attention", what, err,
              lambda: flash_attention(q, k, v, causal=True),
              lambda: ref.flash_attention_ref(q, k, v, causal=True),
              lambda: sdpa(q, k, v, is_causal=True), "sdpa", nbytes, nops,
              peak, peak_name,
              BF16_OPS_PER_S if dtype == torch.float32 else None)
        del q, k, v
    # the [lm] qwen3-32b prefill's layer, bf16: the main path's shape,
    # timed last (the kernel's own keys); [lm] holds B6 on the prefill's
    # own q/k/v
    a = LM_ATTN_SHAPE
    q, k, v = attn_inputs(torch, torch.bfloat16, seed=2, a=a)
    what = (f"bf16 B={a['B']} H={a['H']} S={a['S']} d={a['d']} causal "
            f"([lm] qwen3-32b prefill layer)")
    err = held("flash_attention", flash_attention(q, k, v, causal=True),
               ref.flash_attention_ref(q, k, v, causal=True),
               **ATTN_TOL["bfloat16"], what=what)
    timed("flash_attention", what, err,
          lambda: flash_attention(q, k, v, causal=True),
          lambda: ref.flash_attention_ref(q, k, v, causal=True),
          lambda: sdpa(q, k, v, is_causal=True), "sdpa",
          4 * q.numel() * q.element_size(),
          2.0 * a["S"] ** 2 * a["d"] * a["H"] * a["B"], BF16_OPS_PER_S,
          "dense bf16")
    del q, k, v
    for dtype in (torch.float32, torch.bfloat16):
        for (BH, S, d, causal) in ((3, 256, 64, False), (2, 128, 32, True),
                                   (2, 384, 100, True)):
            q, k, v = (torch.randn((1, BH, S, d), generator=g,
                                   device=DEVICE).to(dtype)
                       for _ in range(3))
            held("flash_attention", flash_attention(q, k, v, causal=causal),
                 ref.flash_attention_ref(q, k, v, causal=causal),
                 **ATTN_TOL[str(dtype)[6:]],
                 what=f"edge {str(dtype)[6:]} H={BH} S={S} d={d} "
                      f"causal={causal}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# the [train] qwen3-32b layer as B6's backward gets it (TRAIN_SHAPE), and
# a smaller f32 one; B5's backward at FULL widths at serve_p99's batch and
# at the training batch (SHAPES["train_batch"], the main path's, last)
TRAIN_ATTN_SHAPE = dict(B=4, H=64, H_KV=8, S=1024, d=128)
TRAIN_ATTN_F32 = dict(B=1, H=16, H_KV=8, S=512, d=128)
CIN_TRAIN_BATCHES = (512, 65536)
# a bf16 gradient against its plain version, element by element: rtol
# two bf16 steps (B6's forward rule, 1.6e-2) of the element, plus an atol
# of BF16_GRAD_ATOL_STEPS bf16 steps (2^-7 each) of the RMS of the
# element's row (one head's d-vector at one position).  The backward
# rounds P and dS to bf16 before its products (FA2), so an element's
# error scales with the terms summed into its row, not with the element
# itself (which may cancel to near 0) nor with the gradient's largest
# entries (at the first positions, 100x a typical one).  A row that is 0
# in exact arithmetic (dQ of the first query under the causal mask: its
# one score's gradient P (dP - Delta) is 0) keeps only float32 residues
# of that cancellation: its RMS is floored at BF16_GRAD_ROW_FLOOR of the
# whole gradient's
BF16_GRAD_TOL = 1.6e-2
BF16_GRAD_ATOL_STEPS = 4
BF16_GRAD_ROW_FLOOR = 2.0 ** -8
# the query tile of the backward kernel (kBq in csrc/flash_attn_bwd.cu)
BWD_QUERY_TILE = 64
# B6's backward on the paths [train]'s layer (bf16 by TMA at d = 128) does
# not take, in both dtypes, causal and full: d 13 (the producer's own
# scalar loads), 16 (its own 16-byte loads at a padded width of 64, as the
# smoke LMs train), 64 (bf16 by TMA at a padded width of 64) and 96 (its
# own loads at 128); B5's weight gradient at ragged K, H, M, D
ATTN_RAGGED = dict(B=1, H=4, H_KV=4, S=256)
ATTN_RAGGED_D = (13, 16, 64, 96)
CIN_RAGGED = dict(B=100, H=7, M=5, D=3, K=65)
# B5's gradients against float64: the reference's CIN tolerance (3e-4),
# of the gradient's largest magnitude
CIN_GRAD_TOL = 3e-4


def held_scaled(torch, rec, name, got, want, tol, what):
    """``max |got - want| <= tol * max |want|`` (logged; fails the run if
    not); returns the absolute error."""
    scale = float(want.float().abs().max())
    return held_rec(torch, rec, name, got, want, 0.0, tol * scale,
                    f"{what}, tol {tol:g} x max {scale:.3g}")


def bf16_grad_check(torch, got, want):
    """``(ok, worst, median)``: at every element ``|got - want| <=
    BF16_GRAD_TOL * |want| + atol``, ``atol`` BF16_GRAD_ATOL_STEPS bf16
    steps of the RMS of the element's row of ``want`` (at least
    BF16_GRAD_ROW_FLOOR of the RMS of all of ``want``); ``worst`` is the
    largest ratio of an element's error to its allowance (``ok`` iff it
    is at most 1), ``median`` the median allowance."""
    w = want.float()
    err = (got.float() - w).abs()
    floor = BF16_GRAD_ROW_FLOOR * float(w.square().mean().sqrt())
    rms = w.square().mean(-1, keepdim=True).sqrt().clamp_min(floor)
    allow = BF16_GRAD_TOL * w.abs() + BF16_GRAD_ATOL_STEPS * 2.0 ** -7 * rms
    return (bool((err <= allow).all()),
            float((err / allow.clamp_min(1e-30)).max()),
            float(allow.median()))


def held_bf16_grad(torch, rec, name, got, want, what):
    """A bf16 gradient held element by element (``bf16_grad_check``;
    logged, fails the run if not); returns the absolute error."""
    err = max_abs_err(torch, got.float(), want.float())
    ok, worst, median = bf16_grad_check(torch, got, want)
    loose = BF16_GRAD_TOL * float(want.float().abs().max())
    log(f"  {name:16s} {what:44s} max_abs_err={err:.3e} (rtol "
        f"{BF16_GRAD_TOL:g}, atol {BF16_GRAD_ATOL_STEPS} bf16 steps of the "
        f"row's RMS: largest error / allowance {worst:.3f}, median "
        f"allowance {median:.3e} against {loose:.3e} for one bound of "
        f"{BF16_GRAD_TOL:g} x max |want|; {'ok' if ok else 'FAILED'})")
    check(ok, f"{name} disagrees with its plain version ({what})")
    r = rec.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    return err


def bf16_grad_faults(torch, q, k, v, o, lse, do, wants):
    """The bf16 gradient check must reject three planted faults of the
    backward, made from the plain version: dK and dV with the last query
    tile dropped (dO zeroed on the last BWD_QUERY_TILE queries), dK and dV
    with the causal diagonal masked (each key's own query's term taken
    off), and dQ without the last key block's contribution (the last
    BWD_KEY_BLOCK keys' terms taken off).  Logged beside the allowance of
    one bound scaled by the largest entry; fails the run if the check
    accepts any fault."""
    from repro_torch.kernels import flash_attn, ref
    S, scale = q.shape[2], q.shape[-1] ** -0.5
    do_cut = do.clone()
    do_cut[:, :, S - BWD_QUERY_TILE:] = 0
    _, dk_cut, dv_cut = ref.flash_attention_bwd_ref(q, k, v, o, lse, do_cut,
                                                    True)
    del do_cut
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    p = torch.exp((qf * kf).sum(-1) * scale - lse)[..., None]
    ds = p * ((dof * vf).sum(-1) - (dof * of).sum(-1))[..., None]
    dk_diag = (wants[1].float() - ds * qf * scale).to(k.dtype)
    dv_diag = (wants[2].float() - p * dof).to(v.dtype)
    # the last key block's terms of dQ: dS[:, :, :, last] k[last] / sqrt(d)
    kb = flash_attn.BWD_KEY_BLOCK
    kl, vl = kf[:, :, S - kb:], vf[:, :, S - kb:]
    pl = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kl) * scale
                   - lse[..., None])
    keys = torch.arange(S - kb, S, device=q.device)
    rows = torch.arange(S, device=q.device)
    pl = torch.where(keys[None, :] <= rows[:, None], pl, 0.0)
    dsl = pl * (torch.einsum("bhqd,bhkd->bhqk", dof, vl)
                - (dof * of).sum(-1)[..., None])
    dq_cut = (wants[0].float() - torch.einsum("bhqk,bhkd->bhqd", dsl, kl)
              * scale).to(q.dtype)
    del qf, kf, vf, of, dof, p, ds, kl, vl, pl, dsl
    named = dict(dq=wants[0], dk=wants[1], dv=wants[2])
    for fault, grads in (
            (f"last {BWD_QUERY_TILE}-query tile dropped",
             dict(dk=dk_cut, dv=dv_cut)),
            ("causal diagonal masked", dict(dk=dk_diag, dv=dv_diag)),
            (f"dQ without the last {kb}-key block", dict(dq=dq_cut))):
        caught = False
        for gname, got in grads.items():
            want = named[gname]
            ok, worst, _ = bf16_grad_check(torch, got, want)
            err = max_abs_err(torch, got.float(), want.float())
            loose = BF16_GRAD_TOL * float(want.float().abs().max())
            log(f"  planted fault ({fault}) {gname}: max_abs_err "
                f"{err:.3e}, largest error / allowance {worst:.3f}: "
                f"{'accepted' if ok else 'rejected'} (one bound of "
                f"{BF16_GRAD_TOL:g} x max |want| = {loose:.3e} would "
                f"{'accept' if err <= loose else 'reject'} it)")
            caught = caught or not ok
        check(caught, f"the bf16 gradient check accepts a planted fault "
                      f"({fault})")


def bwd_kernel_phase(torch, rec):
    """The backward kernels against their plain versions: B6's
    (``attn_bwd_check``), then B5's (``cin_bwd_check``)."""
    attn_bwd_check(torch, rec)
    cin_bwd_check(torch, rec)


def attn_bwd_check(torch, rec):
    """B6's forward with the log-sum-exp and its backward against their
    plain versions at the [train] qwen3-32b layer (bf16, with the planted
    faults of ``bf16_grad_faults``) and at a smaller f32 shape, each
    backward run twice on the same inputs (a dQ accumulator left unzeroed
    shows in the second), timed against SDPA's backward (autograd of
    ``scaled_dot_product_attention``); then the head widths of
    ``ATTN_RAGGED_D`` (the kernel's other paths), causal and full."""
    from repro_torch.kernels import flash_attn, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype, d, causal in itertools.product(
            (torch.float32, torch.bfloat16), ATTN_RAGGED_D, (True, False)):
        name = str(dtype)[6:]
        a = dict(ATTN_RAGGED, d=d)
        q, k, v = attn_inputs(torch, dtype, seed=5, a=a)
        do = torch.randn(q.shape, generator=torch.Generator(
            device=DEVICE).manual_seed(6), device=DEVICE).to(dtype)
        what = (f"{name} B={a['B']} H={a['H']} S={a['S']} d={d} "
                f"{'causal' if causal else 'full'}")
        o, lse = flash_attn._forward(q, k, v, causal, with_lse=True)
        grads = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal)
        wants = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
        for gname, got, want in zip(("dq", "dk", "dv"), grads, wants):
            if dtype == torch.bfloat16:
                held_bf16_grad(torch, rec, "flash_attention_bwd", got, want,
                               f"{what} {gname}")
            else:
                held_rec(torch, rec, "flash_attention_bwd", got, want,
                         what=f"{what} {gname}", **ATTN_TOL[name])
    for dtype, a in ((torch.float32, TRAIN_ATTN_F32),
                     (torch.bfloat16, TRAIN_ATTN_SHAPE)):
        name = str(dtype)[6:]
        q, k, v = attn_inputs(torch, dtype, seed=3, a=a)
        do = torch.randn(q.shape, generator=torch.Generator(
            device=DEVICE).manual_seed(4), device=DEVICE).to(dtype)
        what = (f"{name} B={a['B']} H={a['H']} (K/V repeated from "
                f"{a['H_KV']}) S={a['S']} d={a['d']} causal")
        o, lse = flash_attn._forward(q, k, v, True, with_lse=True)
        want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, True)
        err = held_rec(torch, rec, "flash_attention_lse", o, want_o,
                       what=what + " out", **ATTN_TOL[name])
        err = max(err, held_rec(torch, rec, "flash_attention_lse", lse,
                                want_lse, what=what + " lse",
                                **ATTN_TOL["float32"]))
        wants = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True)
        b_err = 0.0
        for run in ("run 1", "run 2"):
            grads = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, True)
            for gname, got, want in zip(("dq", "dk", "dv"), grads, wants):
                if dtype == torch.bfloat16:
                    e = held_bf16_grad(torch, rec, "flash_attention_bwd",
                                       got, want, f"{what} {gname}, {run}")
                else:
                    e = held_rec(torch, rec, "flash_attention_bwd", got,
                                 want, what=f"{what} {gname}, {run}",
                                 **ATTN_TOL[name])
                b_err = max(b_err, e)
        if dtype == torch.bfloat16:
            bf16_grad_faults(torch, q, k, v, o, lse, do, wants)
        del grads, wants, want_o, want_lse
        B, H, S, d = a["B"], a["H"], a["S"], a["d"]
        elt = q.element_size()
        peak, peak_name = ((BF16_OPS_PER_S, "dense bf16")
                           if dtype == torch.bfloat16 else
                           (FP32_OPS_PER_S, "f32"))
        timed_rec(torch, rec, "flash_attention_lse", what, err,
                  lambda: flash_attn._forward(q, k, v, True, with_lse=True),
                  lambda: ref.flash_attention_fwd_ref(q, k, v, True),
                  lambda: sdpa(q, k, v, is_causal=True), "sdpa",
                  4 * q.numel() * elt + 4 * B * H * S,
                  2.0 * S * S * d * B * H, peak, peak_name)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_out = sdpa(*leaves, is_causal=True)
        # bytes: q, k, v, o, dO read, dq, dk, dv written, lse and D; five
        # products of S*S*d multiply-adds a head, half of them masked
        timed_rec(torch, rec, "flash_attention_bwd", what, b_err,
                  lambda: flash_attn.flash_attention_bwd(q, k, v, o, lse, do,
                                                         True),
                  lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                      True),
                  lambda: torch.autograd.grad(lib_out, leaves, do,
                                              retain_graph=True),
                  "sdpa backward", 8 * q.numel() * elt + 8 * B * H * S,
                  5.0 * S * S * d * B * H, peak, peak_name)
        del q, k, v, do, o, lse, leaves, lib_out
        torch.cuda.empty_cache()


def wgrad_exact(ref, up, xk, x0):
    """``cin_weight_grad`` in float64, in parts of at most 4,096 samples."""
    step = min(up.shape[0], 4096)
    return sum(ref.cin_weight_grad_ref(
        up[i:i + step].double(), xk[i:i + step].double(),
        x0[i:i + step].double()) for i in range(0, up.shape[0], step))


def wgrad_fault(torch, up, xk, x0, exact, what):
    """``held_scaled`` at CIN_GRAD_TOL must reject a planted fault made from
    the plain version: dW without the last stage of WG_COLS columns b * D
    + d (the kernel's chunk of the reduction).  Logged; fails the run if
    the check accepts it."""
    from repro_torch.kernels import cin, ref
    B, K, D = up.shape
    c_lo = (B * D - 1) // cin.WG_COLS * cin.WG_COLS   # the last stage
    b_lo = c_lo // D
    cols = torch.arange(b_lo * D, B * D, device=up.device).view(-1, 1, D)
    last = up[b_lo:] * (cols >= c_lo)
    dw_cut = exact - ref.cin_weight_grad_ref(last.double(),
                                             xk[b_lo:].double(),
                                             x0[b_lo:].double())
    err = float((dw_cut - exact).abs().max())
    allow = CIN_GRAD_TOL * float(exact.abs().max())
    log(f"  planted fault (dW without the last {cin.WG_COLS}-column stage, "
        f"{B * D - c_lo} columns) {what}: max_abs_err {err:.3e} against "
        f"{allow:.3e} ({CIN_GRAD_TOL:g} x max): "
        f"{'accepted' if err <= allow else 'rejected'}")
    check(err > allow, f"the scaled weight-gradient check accepts a planted "
                       f"fault ({what})")


def cin_bwd_check(torch, rec):
    """``cin_weight_grad`` and the whole B5 backward (input gradients
    through the forward kernel with permuted weights, dx_0 split over 191
    fields) at FULL widths, B 512 and 65,536, against float64, timed
    against the einsum forms; ``cin_weight_grad`` run twice on the same
    inputs at each shape and at the ragged ``CIN_RAGGED``, and its planted
    fault (``wgrad_fault``) rejected at each FULL shape."""
    from repro_torch.kernels import cin, ref
    g = torch.Generator(device=DEVICE).manual_seed(6)
    r = CIN_RAGGED
    up, xk, x0 = (torch.randn(shape, generator=g, device=DEVICE) for shape in
                  ((r["B"], r["K"], r["D"]), (r["B"], r["H"], r["D"]),
                   (r["B"], r["M"], r["D"])))
    exact = wgrad_exact(ref, up, xk, x0)
    for run in ("run 1", "run 2"):
        held_scaled(torch, rec, "cin_weight_grad",
                    cin.cin_weight_grad(up, xk, x0), exact, CIN_GRAD_TOL,
                    "B={B} H={H} M={M} D={D} K={K} vs f64, ".format(**r)
                    + run)
    c = CIN_SHAPE
    M, D, K = c["M"], c["D"], c["K"]
    for B in CIN_TRAIN_BATCHES:
        for H in (M, 200):
            def draw(*shape):
                return torch.randn(shape, generator=g, device=DEVICE)
            xk, x0, w, up = (draw(B, H, D), draw(B, M, D), draw(K, H, M),
                             draw(B, K, D))
            what = f"B={B} H={H} M={M} D={D} K={K}"
            step = min(B, 4096)
            exact = wgrad_exact(ref, up, xk, x0)
            for run in ("run 1", "run 2"):
                dw = cin.cin_weight_grad(up, xk, x0)
                err = held_scaled(torch, rec, "cin_weight_grad", dw, exact,
                                  CIN_GRAD_TOL, f"{what} vs f64, {run}")
            wgrad_fault(torch, up, xk, x0, exact, what)
            del exact
            # the whole backward through the autograd path: dx_k and dx_0
            # (B5 with permuted weights, dx_0 in ceil(H / 191) calls) on
            # the first rows against float64
            leaves = [t.clone().requires_grad_() for t in (xk, x0, w)]
            out = cin.cin_layer(*leaves)
            grads = torch.autograd.grad(out, leaves, up, retain_graph=True)
            rows = slice(0, step)
            wants = ref.cin_layer_bwd_ref(xk[rows].double(),
                                          x0[rows].double(), w.double(),
                                          up[rows].double())
            for gname, got, want in zip(("dx_k", "dx_0"), grads, wants):
                held_scaled(torch, rec, "cin_layer", got[rows], want,
                            CIN_GRAD_TOL, f"backward {gname} {what} rows "
                            f"0..{step - 1} vs f64")
            del wants
            nops = 2.0 * K * H * M * D * B
            nbytes = 4 * (B * (H + M + K) * D + K * H * M)
            if B * H * M * D * 4 <= 2 ** 33:
                def plain():
                    return ref.cin_weight_grad_ref(up, xk, x0)
                plain_what = "plain"
            else:                       # the outer product in 8 parts
                def plain():
                    part = B // 8
                    return sum(ref.cin_weight_grad_ref(
                        up[i:i + part], xk[i:i + part], x0[i:i + part])
                        for i in range(0, B, part))
                plain_what = "plain in 8 parts of the batch"
            bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
                out, leaves, up, retain_graph=True), reps=5, warmup=1)
            z_gb = B * H * M * D * 4 / 1e9
            lib_bwd_ms = None
            if z_gb <= 8:               # the einsum keeps [B, H, M, D]
                lib_leaves = [t.clone().requires_grad_()
                              for t in (xk, x0, w)]
                lib_out = torch.einsum("bhd,bmd,khm->bkd", *lib_leaves)
                lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, lib_leaves, up, retain_graph=True), reps=5,
                    warmup=1)
                del lib_out, lib_leaves
            log(f"  B5 backward {what} (dx_k, dx_0, dw; autograd): "
                f"{bwd_ms:.4f} ms, launches "
                f"{cin.backward_launches(H, M)}; autograd of the einsum "
                f"form " + (f"{lib_bwd_ms:.4f} ms" if lib_bwd_ms else
                            f"not measured (its [B, H, M, D] intermediates "
                            f"take {z_gb:.1f} GB each)")
                + f" (events); bound {3 * nops / FP32_OPS_PER_S * 1e3:.4f} "
                f"ms (operations, f32)")
            timed_rec(torch, rec, "cin_weight_grad", what + f" ({plain_what})",
                      err, lambda: cin.cin_weight_grad(up, xk, x0), plain,
                      lambda: torch.einsum("bhd,bmd,bkd->khm", xk, x0, up),
                      "einsum", nbytes, nops, tc_ops_per_s=TF32_OPS_PER_S,
                      plain_reps=3)
            rec["cin_weight_grad"]["shapes"][-1].update(
                backward_ms=bwd_ms, autograd_einsum_ms=lib_bwd_ms)
            del xk, x0, w, up, dw, leaves, out, grads
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def scipy_dist(n, src, dst, w, sources):
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    m = csr_matrix((np.asarray(w, np.float64), (src, dst)), shape=(n, n))
    return dijkstra(m, directed=True, indices=list(sources))


def solve_timed(torch, solver, what, source, batch):
    """solve(source) and solve_batch(batch), each timed on the host clock
    around work that ends in a synchronize; launch counts per run."""
    from repro_torch.kernels import _build
    out = {}
    for kind in ("solve", "solve_batch"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = (solver.solve(source) if kind == "solve"
               else solver.solve_batch(batch))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _build.launch_counts()
        rounds = (res.rounds if kind == "solve" else int(res.rounds.max()))
        edges = res.edges_relaxed
        if kind == "solve_batch" and edges is not None:
            edges = int(np.asarray(edges).sum())
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {what} {kind}: {ms:.1f} ms, rounds {rounds}, "
            f"{ms / max(rounds, 1):.3f} ms/round, edges_relaxed {edges}, "
            f"host syncs {res.host_syncs} "
            f"({res.host_syncs / max(rounds, 1):.2f}/round), "
            f"peak {mem:.2f} GiB, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        out[kind] = dict(res=res, ms=ms, rounds=rounds, launches=launches,
                         edges_relaxed=edges, host_syncs=res.host_syncs,
                         peak_gib=mem)
    return out


def same(torch, a, b) -> bool:
    return (torch.equal(a.dist.cpu(), b.dist.cpu())
            and torch.equal(a.C.cpu(), b.C.cpu())
            and torch.equal(a.fixed.cpu(), b.fixed.cpu())
            and a.rounds == b.rounds and a.fixed_by == b.fixed_by)


def against_scipy(torch, res_dists, n, src, dst, w, sources, what):
    want = scipy_dist(n, src, dst, w, sources)
    for i, s in enumerate(sources):
        got = res_dists[i].double().cpu().numpy()
        ok = np.array_equal(np.isinf(got), np.isinf(want[i]))
        fin = np.isfinite(want[i])
        ok = ok and np.allclose(got[fin], want[i][fin], rtol=1e-4, atol=1e-5)
        rel = float(np.max(np.abs(got[fin] - want[i][fin])
                           / np.maximum(want[i][fin], 1e-30))) if fin.any() \
            else 0.0
        log(f"  {what} source {s} vs scipy float64 dijkstra: "
            f"max rel err {rel:.3e} (tolerance rtol 1e-4)")
        check(ok, f"{what}: distances from {s} disagree with scipy")


def main_path(torch, pt):
    sssp = pt["sssp"]
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(2024)
    runs = {}

    # --- grid side 1024: auto -> frontier ------------------------------
    n, src, dst, w = graph_arrays(pt, "grid")
    g = sssp.build_graph(n, src, dst, w, device=dev)
    batch = [int(s) for s in rng.choice(n, 8, replace=False)]
    s0 = batch[0]
    # a DynamicSolver: its tracked batch is [dynamic]'s grid baseline
    solver = pt["grid_solver"] = sssp.DynamicSolver(g, backend="auto")
    log(f"[main] grid side 1024: n={n} e={g.e}, auto -> {solver.backend} "
        f"(cap {solver.frontier_cap})")
    check(solver.backend == "frontier", "auto did not route grid to "
                                        "frontier")
    runs["grid/frontier"] = r = solve_timed(torch, solver, "grid frontier",
                                            s0, batch)
    r["solve_batch"]["sources"] = batch     # [p2p] reuses this batch
    check(r["solve"]["launches"]["frontier_relax_csr"] > 0 and
          r["solve_batch"]["launches"]["frontier_relax_csr"] > 0,
          "the frontier route launched no fused frontier relax")
    grid_front = r["solve"]["res"]
    against_scipy(torch, [grid_front.dist, r["solve_batch"]["res"].dist[1]],
                  n, src, dst, w, [s0, batch[1]], "grid frontier")
    check(torch.equal(r["solve_batch"]["res"].dist[0], grid_front.dist),
          "grid: batch lane 0 differs from the single solve")
    # backends bitwise on the same graph, launches counted
    for be in ("segment", "pallas"):
        other = sssp.Solver(g, backend=be)
        t0 = time.perf_counter()
        res, lc = counted(torch, lambda: other.solve(s0))
        ms = (time.perf_counter() - t0) * 1e3
        log(f"  grid {be} solve: {ms:.1f} ms, rounds {res.rounds}, "
            f"launches { {k: v for k, v in lc.items() if v} }")
        runs[f"grid/{be}"] = {"solve": dict(res=res, ms=ms, launches=lc)}
        check(same(torch, res, grid_front), f"grid: {be} differs from "
                                            "frontier")
        if be == "pallas":
            check(lc["relax_ell"] > 0
                  and lc["masked_min_pair"] == res.rounds,
                  f"the grid pallas route launched B4 "
                  f"{lc['masked_min_pair']} times in {res.rounds} rounds "
                  "(want one a round) or no ELL relax")
    log("  grid: segment, pallas and frontier bitwise identical "
        "(dist, C, fixed, rounds, fixed_by)")
    del solver, other, g

    # --- gnp 2^20: auto -> segment, and pallas ------------------------
    n, src, dst, w = graph_arrays(pt, "gnp")
    g = sssp.build_graph(n, src, dst, w, device=dev)
    batch = [int(s) for s in rng.choice(n, 8, replace=False)]
    s0 = batch[0]
    seg = sssp.Solver(g, backend="auto")
    log(f"[main] gnp n={n} e={g.e}: auto -> {seg.backend}")
    check(seg.backend == "segment", "auto did not route gnp to segment")
    runs["gnp/segment"] = rs = solve_timed(torch, seg, "gnp segment", s0,
                                           batch)
    pal = sssp.Solver(g, backend="pallas")
    log(f"[main] gnp pallas: ELL n_pad={pal.ell.n_pad} "
        f"deg_pad={pal.ell.deg_pad}")
    runs["gnp/pallas"] = rp = solve_timed(torch, pal, "gnp pallas", s0,
                                          batch)
    for kind in ("solve", "solve_batch"):
        lc, rounds = rp[kind]["launches"], rp[kind]["rounds"]
        check(lc["relax_ell"] > 0 and lc["masked_min_pair"] == rounds,
              f"the gnp pallas {kind} launched B4 {lc['masked_min_pair']} "
              f"times in {rounds} rounds (want one a round) or no ELL "
              "relax")
    against_scipy(torch, [rs["solve"]["res"].dist,
                          rs["solve_batch"]["res"].dist[1]],
                  n, src, dst, w, [s0, batch[1]], "gnp segment")
    check(same(torch, rs["solve"]["res"], rp["solve"]["res"]),
          "gnp: pallas differs from segment (solve)")
    bs, bp = rs["solve_batch"]["res"], rp["solve_batch"]["res"]
    check(torch.equal(bs.dist, bp.dist) and torch.equal(bs.C, bp.C)
          and np.array_equal(bs.rounds, bp.rounds)
          and bs.fixed_by == bp.fixed_by,
          "gnp: pallas differs from segment (solve_batch)")
    log("  gnp: segment and pallas bitwise identical (solve and batch)")
    del seg, pal, g
    torch.cuda.empty_cache()
    return runs


def sync_debugged(torch, fn):
    """``fn()`` on the card under torch's sync debug mode; returns its
    result, the launch counts of the run and the host syncs the engine
    does not count (``SyncCounter.read`` lifts the debug mode for its own
    reads, so every flagged call is one of those)."""
    from repro_torch.kernels import _build
    _build.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    hidden = sorted({f"{Path(c.filename).name}:{c.lineno}" for c in caught
                     if "synchroniz" in str(c.message)})
    launches = {k: v for k, v in _build.launch_counts().items() if v}
    return out, launches, hidden


def batch_rows(res) -> dict:
    """A batch or fleet result's fields as host values (numpy arrays,
    lists), the form both sides of ``[parity]`` are compared in."""
    return dict(
        dist=res.dist.cpu().numpy(), C=res.C.cpu().numpy(),
        fixed=res.fixed.cpu().numpy(),
        rounds=np.asarray(res.rounds).tolist(), fixed_by=res.fixed_by,
        edges=None if res.edges_relaxed is None
        else np.asarray(res.edges_relaxed).tolist(),
        host_syncs=res.host_syncs, partial=getattr(res, "partial", None))


def bidi_rows(r) -> dict:
    """A ``BidiResult``'s fields as host values (f32 bits of distance and
    mu)."""
    return dict(
        D=r.D.cpu().numpy(), C=r.C.cpu().numpy(),
        fixed=r.fixed.cpu().numpy(), rounds=r.rounds, fixed_by=r.fixed_by,
        meeting=r.meeting, edges=r.edges_relaxed, path=r.path(),
        host_syncs=r.host_syncs,
        distance=np.float32(r.distance).tobytes(),
        mu=np.float32(r.mu).tobytes())


def same_rows(a, b) -> bool:
    """Two ``*_rows`` structures equal, arrays bitwise and of one dtype."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_rows(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_rows(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def parity_runs(torch, sssp, gen, family, n, device, c0, wrap):
    """Every ``[parity]`` run of one family on ``device``, each group of
    runs through ``wrap(fn) -> (result, launches, uncounted syncs)``:
    the card's sync debug mode, or a plain call on the CPU.

    * ``DynamicSolver`` on "auto" and "pallas": a cold ``solve_batch``, a
      warm update of 64 random edges (stats included) and the resolved
      rows, then a targeted ``solve_batch`` seeded with ``c0`` (the card
      index's seeds, the same on both sides);
    * ``BidirectionalSolver`` on "segment" and "frontier": two pairs;
    * a 3-member fleet (seeds 2-4) on "segment" and "frontier": a cold
      ``solve``, ``update`` with per-member deltas and ``resolve``.  The
      frontier route's maintenance walks gather ``[cap, max_out_deg,
      max_in_deg]`` cells a chunk, hub degrees squared on power_law:
      that family's frontier fleet runs at 2^9 with a buffer of 64 (its
      overflow rounds relax densely).

    Returns ``{(kind, route): (rows, launches, uncounted)}``."""
    out = {}
    nn, src, dst, w = gen.make(family, n, seed=1)
    g = sssp.build_graph(nn, src, dst, w, device=device)
    sources, targets = [0, nn // 2], [nn - 1, nn // 3]
    c0 = torch.as_tensor(c0, device=device)
    for be in ("auto", "pallas"):
        dyn = sssp.DynamicSolver(g, backend=be, device=device)
        delta = sssp.random_delta(g, 64, seed=5)
        (cold, stats, warm, p2p), lc, hidden = wrap(lambda: (
            dyn.solve_batch(sources), dyn.update(delta),
            dyn.resolve(sources),
            dyn.solve_batch(sources, targets=targets, C0=c0)))
        out[("dynamic", dyn.backend)] = (dict(
            cold=batch_rows(cold), stats=stats, warm=batch_rows(warm),
            p2p=batch_rows(p2p)), lc, hidden)
    pairs = [(0, nn - 1), (nn // 2, nn // 3)]
    for be in ("segment", "frontier"):
        bidi = sssp.BidirectionalSolver(g, backend=be, device=device)
        res, lc, hidden = wrap(lambda: [bidi.solve(s, t) for s, t in pairs])
        out[("bidi", be)] = ([bidi_rows(r) for r in res], lc, hidden)
    for be in ("segment", "frontier"):
        hub = be == "frontier" and family == "power_law"
        arrays = [gen.make(family, PARITY_HUB_N if hub else nn, seed=s)
                  for s in (2, 3, 4)]
        nb = arrays[0][0]
        fleet = sssp.build_fleet(arrays, device=device)
        deltas = sssp.stack_deltas([
            sssp.random_delta(m, 16 + 8 * i, seed=7 + i)
            for i, m in enumerate(fleet.members())])
        fs = sssp.FleetSolver(fleet, backend=be,
                              frontier_cap=64 if hub else None)
        (cold, stats, warm), lc, hidden = wrap(lambda: (
            fs.solve([0, nb // 2, nb - 1]), fs.update(deltas),
            fs.resolve()))
        out[("fleet", be)] = (dict(n=nb, cold=batch_rows(cold), stats=stats,
                                   warm=batch_rows(warm)), lc, hidden)
    return out


def parity_cpu(family, n, c0):
    """The CPU side of one family's ``[parity]`` runs, in a worker
    process (the plain versions of the kernels, 2 threads)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import sssp
    from repro_torch.core import generators
    torch.set_num_threads(2)
    return parity_runs(torch, sssp, generators, family, n, "cpu", c0,
                       lambda fn: (fn(), {}, []))


def cpu_parity_phase(torch, pt):
    """The card's solves equal the port's CPU solves (plain versions)
    bitwise on 2^12-vertex graphs of every family (``parity_runs``:
    warm updates and seeded targeted batches on two routes,
    bidirectional pairs and 3-member fleets on two routes each), then
    the service and the baselines (``serve_parity_runs``).  The card's
    runs go under
    torch's sync debug mode, which names every host sync the engine's own
    count misses.  The CPU sides run in 3 worker processes while the card
    runs its side (the seeds, from the card's 4-landmark indexes, are
    made for every family first)."""
    import concurrent.futures
    import multiprocessing
    gen, sssp = pt["generators"], pt["sssp"]
    n = PARITY_N

    def card(fn):
        return sync_debugged(torch, fn)
    seeds = {}
    for family in gen.FAMILIES:
        nn, src, dst, w = gen.make(family, n, seed=1)
        g = sssp.build_graph(nn, src, dst, w, device=DEVICE)
        seeds[family] = sssp.LandmarkIndex(g, k=4, seed=1).seed_batch(
            [0, nn // 2]).cpu().numpy()
    with concurrent.futures.ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        serve_job = pool.submit(serve_parity_cpu, n)
        jobs = {f: pool.submit(parity_cpu, f, n, c0)
                for f, c0 in seeds.items()}
        done = [(f, parity_runs(torch, sssp, gen, f, n, DEVICE, c0, card))
                for f, c0 in seeds.items()]
        for family, on_card in done:
            on_cpu = jobs[family].result()
            for key, (rows, launches, hidden) in on_card.items():
                parity_check(family, key, rows, on_cpu[key][0], launches,
                             hidden)
        on_card = serve_parity_runs(torch, sssp, gen, n, DEVICE, card)
        on_cpu = serve_job.result()
        for key, (rows, launches, hidden) in on_card.items():
            serve_parity_check(key, rows, on_cpu[key][0], launches, hidden)


def parity_check(family, key, a, b, launches, hidden) -> None:
    """One group of ``[parity]`` runs: the card's rows ``a`` against the
    CPU's ``b``, logged and checked (no uncounted sync; the kernels the
    route must launch)."""
    kind, be = key
    what = f"{family}/{kind} {be}"
    ok = same_rows(a, b)
    if kind == "dynamic":
        st = a["stats"]
        log(f"  {family:10s} {be:8s} card == cpu: {ok} (rounds "
            f"{a['cold']['rounds']} / warm {st['warm_rounds']}, sweeps "
            f"{st['sweeps']}, tainted {st['tainted']} / targeted "
            f"{a['p2p']['rounds']}; host syncs {a['cold']['host_syncs']} / "
            f"{st['host_syncs']} / {a['p2p']['host_syncs']}; launches "
            f"{launches}, uncounted {hidden})")
        check(a["p2p"]["partial"], f"{what}: the targeted batch is not "
                                   "partial")
        if be in ("frontier", "pallas"):
            check(bool(launches), f"{what}: no kernel launched")
    elif kind == "bidi":
        rounds = [r["rounds"] for r in a]
        log(f"  {family:10s} bidi {be:8s} card == cpu: {ok} (rounds "
            f"{rounds}, distances "
            f"{[float(np.frombuffer(r['distance'], np.float32)[0]) for r in a]}"
            f", host reads {[r['host_syncs'] for r in a]}; launches "
            f"{launches}, uncounted {hidden})")
        b1 = launches.get("frontier_relax", 0)
        check(b1 == (2 * sum(rounds) if be == "frontier" else 0),
              f"{what}: B1 launched {b1} times in {rounds} rounds")
    else:
        st = a["stats"]
        log(f"  {family:10s} fleet {be:8s} n={a['n']} card == cpu: {ok} "
            f"(rounds {a['cold']['rounds']} / warm {st['warm_rounds']}, "
            f"host reads {a['cold']['host_syncs']} / {st['host_syncs']}; "
            f"launches {launches}, uncounted {hidden})")
        if be == "frontier":
            check(launches.get("frontier_relax_csr", 0) > 0,
                  f"{what}: no B2 launched")
    check(ok, f"{what}: card and CPU differ")
    check(not hidden, f"{what}: host syncs the engine does not count at "
                      f"{hidden}")


def timed_run(torch, fn):
    """``fn()`` once on the host clock, ending in a synchronize, with every
    launch count set to 0 just before and read just after: (its result,
    ms, the counts)."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, _build.launch_counts()


def nonzero(lc) -> dict:
    return {k: v for k, v in lc.items() if v}


def dynamic_phase(torch, pt):
    """Warm re-solves at n = 2^20 through ``DynamicSolver``: grid side
    1024 via "auto" (frontier), gnp 2^20 via "auto" (segment) and via
    "pallas".  Per route: a cold ``solve_batch`` of 8 sources (tracked;
    on the grid the main path's, whose solver tracked it), ``update`` with 1,024 random edges rescaled by uniform[0.5, 2.0]
    (seed 11), then ``resolve``; on gnp also a pure increase of the same
    edges (x uniform[1.0, 2.0]).  Each resolved batch is held bitwise
    (dist, fixed) against a cold ``Solver`` on the mutated graph and two
    sources against scipy on the mutated arrays; the frontier update
    must launch the fused frontier relax, a pallas update ``relax_ell``
    and one ``masked_min_pair`` a warm round.  Returns the launch counts
    of every counted run."""
    sssp = pt["sssp"]
    dev = torch.device(DEVICE)
    runs = []
    keep = {}
    routes = (("grid", graph_arrays(pt, "grid"), "auto", "frontier"),
              ("gnp", graph_arrays(pt, "gnp"), "auto",
               "segment"),
              ("gnp", None, "pallas", "pallas"))
    g = None
    for name, arrays, be, want in routes:
        if arrays is not None:
            n, src, dst, w = arrays
        sources = [int(v) for v in np.random.default_rng(2024).choice(
            n, 8, replace=False)]
        if name == "grid":      # the main path's batch, the same sources
            dyn = pt.pop("grid_solver")
            g = dyn.graph
        else:
            if arrays is not None:
                g = sssp.build_graph(n, src, dst, w, device=dev)
            dyn = sssp.DynamicSolver(g, backend=be)
        e = g.e
        what = f"{name} {dyn.backend}"
        check(dyn.backend == want, f"[dynamic] {name}: {be} routed to "
                                   f"{dyn.backend}, not {want}")
        if name == "grid":
            log(f"  {what}: tracks the main path's solve_batch(8)")
        else:
            cold0, cold0_ms, lc = timed_run(
                torch, lambda: dyn.solve_batch(sources))
            runs.append(lc)
            log(f"  {what}: cold solve_batch(8) {cold0_ms:.1f} ms, rounds "
                f"{int(cold0.rounds.max())}, launches {nonzero(lc)}")
        delta = sssp.random_delta(g, 1024, seed=11)
        kinds = ("mixed x[0.5, 2.0]",) + (
            ("pure increase x[1.0, 2.0]",) if name == "gnp" else ())
        for kind in kinds:
            d = delta
            if kind.startswith("pure"):   # the same edges, each up from
                idx = delta.edge_idx[: delta.k].cpu().numpy()   # its
                old = dyn.graph.w[:e].cpu().numpy()[idx]   # current weight
                d = sssp.make_delta(dyn.graph, idx, old * np.random.
                                    default_rng(12).uniform(
                                        1.0, 2.0, delta.k).astype(np.float32))
            stats, up_ms, lc = timed_run(torch, lambda: dyn.update(d))
            runs.append(lc)
            res, res_ms, _ = timed_run(torch, lambda: dyn.resolve(sources))
            cold_solver = sssp.Solver(dyn.graph, backend=be)
            cold, cold_ms, lc_cold = timed_run(
                torch, lambda: cold_solver.solve_batch(sources))
            runs.append(lc_cold)
            wr = max(stats["warm_rounds"])
            log(f"  {what} update ({kind}, {d.k} edges of {e}, "
                f"{stats['increased']} up / {stats['decreased']} down): "
                f"{up_ms:.1f} ms against a cold solve_batch(8) of the "
                f"mutated graph {cold_ms:.1f} ms; warm rounds {wr} "
                f"({stats['warm_rounds']}) against cold "
                f"{int(cold.rounds.max())}, sweeps {stats['sweeps']}, "
                f"tainted {stats['tainted']}, host reads "
                f"{stats['host_syncs']}; resolve {res_ms:.1f} ms; launches "
                f"{nonzero(lc)}")
            check(stats["warm_refreshed"] == 8 and stats["cold_refreshed"]
                  == 0, f"[dynamic] {what}: {stats}")
            if kind.startswith("pure"):
                check(stats["decreased"] == 0, "[dynamic] the pure "
                                               "increase decreased an edge")
            check(torch.equal(res.dist, cold.dist)
                  and torch.equal(res.fixed, cold.fixed),
                  f"[dynamic] {what} ({kind}): the warm rows differ from "
                  "a cold solve of the mutated graph")
            w_new = dyn.graph.w[:e].cpu().numpy()
            against_scipy(torch, [res.dist[0], res.dist[1]], n,
                          g.src[:e].cpu().numpy(), g.dst[:e].cpu().numpy(),
                          w_new, sources[:2], f"{what} after the update")
            if dyn.backend == "segment" and not kind.startswith("pure"):
                # [distributed] repeats this update at world 2
                keep["distributed"] = dict(
                    sources=list(sources), dist_fixed=digest(cold.dist,
                                                             cold.fixed))
            if dyn.backend == "frontier":
                check(lc["frontier_relax_csr"] > 0, "[dynamic] the frontier "
                      "update launched no fused frontier relax")
                # [bidi] refreshes pairs of these sources after this delta
                keep[name] = dict(sources=list(sources), dist=cold.dist,
                                  w=dyn.graph.w)
            if dyn.backend == "pallas":
                check(lc["relax_ell"] > 0 and lc["masked_min_pair"] == wr,
                      f"[dynamic] the pallas update launched B4 "
                      f"{lc['masked_min_pair']} times in {wr} warm rounds "
                      "(want one a round) or no ELL relax")
        del dyn, cold_solver
    del g
    torch.cuda.empty_cache()
    return runs, keep


def p2p_phase(torch, pt, main_runs):
    """Landmark-seeded targeted queries at n = 2^20.  gnp: an 8-landmark
    index on its default segment backend, 64 (s, t) pairs (seed 2024) in
    batches of 8 through "auto" (segment) and "pallas", each batch
    untargeted, targeted and seeded-targeted; grid side 1024: an index on
    the pallas backend, then 8 seeded targeted pairs through "auto"
    (frontier).  Every lane's target distance is held bitwise against the
    untargeted solve, fixed, the batch stamped partial, and every seed
    <= the full distances.  Then the gnp index takes the [dynamic] gnp
    delta; its refreshed tables are held bitwise against cold solves of
    the mutated graph and of its reverse.  Returns the launch counts of
    every counted run, and per graph what ``[bidi]`` reuses: the graph,
    its index, the pairs, the untargeted distances at the targets and
    each pair's rounds untargeted, targeted and seeded (on the first
    route).  The grid's untargeted batch is the main path's frontier
    ``solve_batch`` of the same 8 sources (one 40 s solve, not two)."""
    sssp = pt["sssp"]
    dev = torch.device(DEVICE)
    runs = []
    keep = {}
    plan = (("gnp", graph_arrays(pt, "gnp"), "segment", 64,
             ("auto", "pallas")),
            ("grid", graph_arrays(pt, "grid"), "pallas", 8, ("auto",)))
    for name, (n, src, dst, w), index_be, pairs, routes in plan:
        g = sssp.build_graph(n, src, dst, w, device=dev)
        rng = np.random.default_rng(2024)
        s_all = rng.choice(n, pairs, replace=False).astype(np.int64)
        t_all = rng.choice(n, pairs, replace=False).astype(np.int64)
        index, build_ms, lc = timed_run(
            torch, lambda: sssp.LandmarkIndex(g, k=8, backend=index_be))
        runs.append(lc)
        tables = torch.cat([index.d_from, index.d_to])
        scale = float(tables[torch.isfinite(tables)].max())
        log(f"  {name}: LandmarkIndex(k=8, backend={index_be!r}) built in "
            f"{build_ms:.1f} ms (landmarks {index.landmarks.tolist()}), "
            f"launches {nonzero(lc)}")
        mine = keep[name] = dict(g=g, index=index, s=s_all, t=t_all,
                                 dist_t=[], rounds={})
        for be in routes:
            solver = sssp.Solver(g, backend=be)
            what = f"{name} {solver.backend}"
            tot = {k: [0.0, 0] for k in ("untargeted", "targeted",
                                         "seeded targeted", "seeds")}
            for lo in range(0, pairs, 8):
                sb, tb = s_all[lo:lo + 8], t_all[lo:lo + 8]
                c0, seed_ms, _ = timed_run(torch,
                                           lambda: index.seed_batch(sb))
                tot["seeds"][0] += seed_ms
                got = {}
                for kind, kw in (("untargeted", {}),
                                 ("targeted", dict(targets=tb)),
                                 ("seeded targeted", dict(targets=tb,
                                                          C0=c0))):
                    hit = main_runs.get(f"{name}/{solver.backend}", {}).get(
                        "solve_batch", {})
                    if kind == "untargeted" and hit.get("sources") == [
                            int(v) for v in sb]:
                        res, ms, lc = hit["res"], hit["ms"], hit["launches"]
                    else:
                        res, ms, lc = timed_run(
                            torch, lambda: solver.solve_batch(sb, **kw))
                        runs.append(lc)
                    r = int(res.rounds.max())
                    tot[kind][0] += ms
                    tot[kind][1] += r
                    got[kind] = res
                    if solver.backend == "pallas":
                        check(lc["relax_ell"] > 0
                              and lc["masked_min_pair"] == r,
                              f"[p2p] {what} {kind}: B4 launched "
                              f"{lc['masked_min_pair']} times in {r} rounds")
                    if solver.backend == "frontier":
                        check(lc["frontier_relax_csr"] > 0, f"[p2p] {what} "
                              "launched no fused frontier relax")
                full = got["untargeted"]
                lanes = torch.arange(len(sb), device=dev)
                tt = torch.as_tensor(tb, device=dev)
                if be == routes[0]:
                    mine["dist_t"].append(full.dist[lanes, tt].cpu().numpy())
                    for kind, res in got.items():
                        mine["rounds"].setdefault(kind, []).extend(
                            int(r) for r in res.rounds)
                for kind in ("targeted", "seeded targeted"):
                    res = got[kind]
                    check(res.partial and torch.equal(
                        res.dist[lanes, tt], full.dist[lanes, tt]),
                        f"[p2p] {what} {kind}: a target distance differs "
                        "from the untargeted solve")
                    check(bool((res.fixed[lanes, tt]
                                | torch.isinf(full.dist[lanes, tt])).all()),
                          f"[p2p] {what} {kind}: a target is not fixed")
                over = (c0 - full.dist)[torch.isfinite(full.dist)]
                tot["over"] = max(tot.get("over", 0.0), float(over.max()))
                tot["n_over"] = tot.get("n_over", 0) + int((over > 0).sum())
                check(bool((c0 <= full.dist + SEED_TOL * scale).all()),
                      f"[p2p] {what}: a landmark seed exceeds the distance "
                      f"by more than {SEED_TOL:g} of the tables' scale")
            nb = pairs // 8
            log(f"  {what}: {pairs} pairs in {nb} batches of 8; seeds "
                f"{tot['seeds'][0] / nb:.2f} ms a batch; " + "; ".join(
                    f"{k} {tot[k][0] / nb:.1f} ms, {tot[k][1] / nb:.1f} "
                    f"rounds a batch" for k in ("untargeted", "targeted",
                                                "seeded targeted"))
                + "; every target bitwise and fixed; seeds above the f32 "
                f"distance: {tot['n_over']} of {pairs * n:,}, by at most "
                f"{tot['over']:.3e} = {tot['over'] / scale:.3e} of the "
                f"tables' largest entry {scale:.1f} (tolerance "
                f"{SEED_TOL:g})")
            del solver
        if name == "gnp":
            delta = sssp.random_delta(g, 1024, seed=11)
            stats, ms, lc = timed_run(torch, lambda: index.apply_delta(delta))
            runs.append(lc)
            lms = [int(v) for v in index.landmarks]
            g2 = index._fwd.graph
            fwd = sssp.Solver(g2, backend="segment").solve_batch(lms)
            rev = sssp.Solver(g2.reverse(), backend="segment").solve_batch(
                lms)
            ok = (torch.equal(index.d_from, fwd.dist)
                  and torch.equal(index.d_to, rev.dist))
            log(f"  gnp index.apply_delta (1024 edges): {ms:.1f} ms, reverse "
                f"warm rounds {stats['warm_rounds']}, sweeps "
                f"{stats['sweeps']}; tables == cold solves of the mutated "
                f"graph and its reverse: {ok}")
            check(ok, "[p2p] the refreshed landmark tables differ from cold "
                      "solves of the mutated graph")
            # [bidi] wants the index of the unmutated graph
            index = sssp.LandmarkIndex(g, k=8, backend=index_be)
            mine["index"] = index
        mine["dist_t"] = np.concatenate(mine["dist_t"])
        del index, g
        torch.cuda.empty_cache()
    return runs, keep


def edge_table(n, src, dst, w):
    """The graph's edges keyed ``u * n + v``, sorted, for ``edge_fold``."""
    key = src.astype(np.int64) * n + dst
    order = np.argsort(key, kind="stable")
    return n, key[order], w[order]


def edge_fold(table, path):
    """The f32 left-to-right fold of ``path``'s edge weights (the least
    of parallel edges) over an ``edge_table``, or None if a step is not
    an edge."""
    n, key, w = table
    p = np.asarray(path, np.int64)
    want = p[:-1] * n + p[1:]
    lo = np.searchsorted(key, want, side="left")
    hi = np.searchsorted(key, want, side="right")
    if (hi <= lo).any():
        return None
    d = np.float32(0.0)
    for a, b in zip(lo, hi):
        d = np.float32(d + w[a:b].min())
    return d


def check_bidi_distance(res, want, table, what, tally):
    """A bidirectional answer against the full solve's ``want = dist[t]``:
    unreachable alike; else ``distance`` is the f32 fold of ``path()``,
    a path of real edges from s to t, bitwise, and ``distance`` and ``mu``
    are within rtol 1e-4 of ``want`` (the tolerance of every distance
    check against scipy).  The stitched path takes parents within the
    reference's tolerance (``atol = 1e-5 * (1 + D)``), so on a near-tie it
    can be near-shortest and fold above ``dist[t]``: ``tally`` counts the
    solves whose distance and mu are bitwise ``dist[t]`` and the largest
    gap in ulps."""
    tally["solves"] += 1
    if not np.isfinite(want):
        check(not np.isfinite(res.distance) and res.path() is None,
              f"{what} ({res.source}, {res.target}): reachable, but the "
              "full solve says not")
        tally["distance"] += 1
        tally["mu"] += 1
        return
    path = res.path()
    check(path is not None and path[0] == res.source
          and path[-1] == res.target, f"{what}: no s-t path")
    fold = edge_fold(table, path)
    check(fold is not None and fold.tobytes()
          == np.float32(res.distance).tobytes(), f"{what} ({res.source}, "
          f"{res.target}): the path is not made of edges that fold to the "
          "distance")
    for name, x in (("distance", res.distance), ("mu", res.mu)):
        check(abs(x - float(want)) <= 1e-4 * abs(float(want)),
              f"{what} ({res.source}, {res.target}): {name} {x!r} is not "
              f"within rtol 1e-4 of dist[t] {float(want)!r}")
        x32 = np.float32(x)
        tally[name] += int(x32.tobytes() == want.tobytes())
        gap = abs(int(x32.view(np.int32)) - int(want.view(np.int32)))
        tally["ulps"] = max(tally["ulps"], gap)


def tally_text(t) -> str:
    return (f"distance bitwise dist[t] in {t['distance']} of {t['solves']} "
            f"solves, mu in {t['mu']}, largest gap {t['ulps']} ulps; every "
            "path real edges folding to the distance")


def bidi_phase(torch, pt, p2p, dyn):
    """Bidirectional point-to-point queries at n = 2^20 on ``[p2p]``'s
    graphs and pairs (seed 2024): the 8 grid pairs through "auto"
    (frontier) and the first 16 gnp pairs through "auto" (segment), each
    unseeded and seeded from ``[p2p]``'s landmark index.  Each answer is
    held to ``[p2p]``'s untargeted ``dist[t]`` (``check_bidi_distance``:
    the path real edges folding to the distance bitwise, distance and mu
    near ``dist[t]``, the bitwise matches counted), a frontier round
    launches B1 exactly twice (a segment round never), and a solve reads
    the host once a round plus 3 times.  Then ``update`` with
    ``[dynamic]``'s 1,024-edge delta refreshes 2 grid and 8 gnp pairs
    warm: each forward lane bitwise a cold solve of the mutated graph
    (``[dynamic]``'s for the grid's sources) and within rtol 1e-4 of
    scipy.  Returns the launch
    counts of every counted run."""
    sssp = pt["sssp"]
    runs = []
    for name, want_be, pairs, n_warm in (("grid", "frontier", 8, 2),
                                          ("gnp", "segment", 16, 8)):
        st = p2p[name]
        g, index = st["g"], st["index"]
        n, e = g.n, g.e
        host = (g.src[:e].cpu().numpy(), g.dst[:e].cpu().numpy())
        table = edge_table(n, *host, g.w[:e].cpu().numpy())
        bidi, build_ms, _ = timed_run(
            torch, lambda: sssp.BidirectionalSolver(g, backend="auto"))
        what = f"{name} {bidi.backend}"
        log(f"  {what}: BidirectionalSolver built in {build_ms:.1f} ms "
            f"(cap {bidi.frontier_cap})")
        check(bidi.backend == want_be, f"[bidi] {name}: auto routed to "
                                       f"{bidi.backend}, not {want_be}")
        tot = {k: [0.0, 0, 0] for k in ("unseeded", "seeded")}
        tally = dict(solves=0, distance=0, mu=0, ulps=0)
        kept = []
        for i in range(pairs):
            s, t = int(st["s"][i]), int(st["t"][i])
            want = np.float32(st["dist_t"][i])
            for kind in ("unseeded", "seeded"):
                c0 = index.seed_pair(s, t) if kind == "seeded" else None
                res, ms, lc = timed_run(torch, lambda: bidi.solve(s, t,
                                                                  C0=c0))
                runs.append(lc)
                tot[kind][0] += ms
                tot[kind][1] += res.rounds
                tot[kind][2] += res.host_syncs
                check_bidi_distance(res, want, table,
                                    f"[bidi] {what} {kind}", tally)
                check(res.host_syncs == res.rounds + (
                    3 if np.isfinite(want) else 2),
                      f"[bidi] {what}: {res.host_syncs} host reads in "
                      f"{res.rounds} rounds")
                b1 = lc["frontier_relax"]
                check(b1 == (2 * res.rounds if bidi.backend == "frontier"
                             else 0), f"[bidi] {what} {kind}: B1 launched "
                      f"{b1} times in {res.rounds} rounds")
                if kind == "unseeded" and i < n_warm:
                    kept.append((s, t, res.D, res.fixed))
        r = st["rounds"]
        log(f"  {what}: {pairs} pairs; rounds a pair unseeded "
            f"{tot['unseeded'][1] / pairs:.1f}, seeded "
            f"{tot['seeded'][1] / pairs:.1f}; [p2p] untargeted "
            f"{np.mean(r['untargeted'][:pairs]):.1f}, targeted "
            f"{np.mean(r['targeted'][:pairs]):.1f}, seeded targeted "
            f"{np.mean(r['seeded targeted'][:pairs]):.1f}; ms a pair "
            f"unseeded {tot['unseeded'][0] / pairs:.1f}, seeded "
            f"{tot['seeded'][0] / pairs:.1f}; host reads a pair "
            f"{tot['unseeded'][2] / pairs:.1f} / "
            f"{tot['seeded'][2] / pairs:.1f} (rounds + 3); {tally_text(tally)}"
            f"; B1 launches 2 a round: {bidi.backend == 'frontier'}")

        delta = sssp.random_delta(g, 1024, seed=11)      # [dynamic]'s
        out, up_ms, lc = timed_run(torch, lambda: bidi.update(delta,
                                                              warm=kept))
        runs.append(lc)
        sources = [s for s, _, _, _ in kept]
        old = dyn.get(name)
        if old is not None and all(s in old["sources"] for s in sources):
            check(torch.equal(old["w"], bidi.graph.w), "[bidi] the grid "
                  "delta differs from [dynamic]'s")
            cold = old["dist"][[old["sources"].index(s) for s in sources]]
            cold_what = "[dynamic]'s cold re-solve"
        else:
            cold = sssp.Solver(bidi.graph, backend="segment").solve_batch(
                sources).dist
            cold_what = "a cold segment solve_batch"
        rounds = []
        tally = dict(solves=0, distance=0, mu=0, ulps=0)
        w1 = bidi.graph.w[:e].cpu().numpy()
        table = edge_table(n, *host, w1)
        for i, (s, t, _, _) in enumerate(kept):
            res = out[(s, t)]
            rounds.append(res.rounds)
            check(torch.equal(res.D[0], cold[i]), f"[bidi] {what}: the "
                  f"refreshed forward lane of ({s}, {t}) differs from "
                  f"{cold_what} of the mutated graph")
            check_bidi_distance(res, np.float32(cold[i, t].item()), table,
                                f"[bidi] {what} refreshed", tally)
        against_scipy(torch, [out[(s, t)].D[0] for s, t, _, _ in kept[:2]],
                      n, *host, bidi.graph.w[:e].cpu().numpy(), sources[:2],
                      f"[bidi] {what} refreshed forward lane")
        log(f"  {what} update(1024 edges, warm={len(kept)} pairs): "
            f"{up_ms:.1f} ms, warm rounds {rounds}; every forward lane "
            f"bitwise {cold_what}; {tally_text(tally)}")
        del bidi, out, kept, cold
        torch.cuda.empty_cache()
    return runs


def fleet_phase(torch, pt):
    """Graph fleets: F = 8 grids of side ``FLEET_SIDE`` (seeds 0-7; at
    128, n = 2^14 and 65,024 edges each).  A segment ``FleetSolver``'s
    ``solve`` (one source a member, seed 2024) and ``solve_batch`` [8,
    8], every member bitwise a per-graph ``Solver(backend="segment")``
    solve, host reads rounds + 2 whatever F; ``update`` with stacked
    deltas of 128 + 32 f random edges a member (x uniform[0.5, 2.0]) and
    ``resolve``, bitwise a cold solve of each mutated member; a frontier
    fleet of the first 2 members, bitwise the segment fleet's rows, B2
    launched.  Then
    ``CongestionReplay`` over 8 grids of side 128 for 6 ticks with a
    dropout at tick 3 and a straggler at tick 4, and again with a
    dropout and on-disk checkpoints (``CheckpointManager``), each bitwise
    a fault-free replay.  Returns the launch counts of every counted
    run."""
    import tempfile
    gen, sssp = pt["generators"], pt["sssp"]
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import FaultInjector
    from repro_torch.runtime.fleet import CongestionReplay
    runs = []
    F = 8
    fleet, build_ms, _ = timed_run(torch, lambda: sssp.build_fleet(
        [gen.grid(FLEET_SIDE, seed=f) for f in range(F)]))
    n = fleet.n
    log(f"  fleet: {F} grids side {FLEET_SIDE}, n={n}, e={fleet.es[0]} "
        f"each ({sum(fleet.es):,} in all), e_pad {fleet.e_pad}; built in "
        f"{build_ms:.1f} ms")
    rng = np.random.default_rng(2024)
    src = rng.choice(n, F, replace=False)
    batch = rng.choice(n, (F, 8), replace=False)
    fs = sssp.FleetSolver(fleet)
    members = fleet.members()
    solvers = [sssp.Solver(m, backend="segment") for m in members]

    def per_graph(kind, fn):
        """Each member's own solves, timed; (results, summed ms)."""
        outs, total = [], 0.0
        for f in range(F):
            r, ms, lc = timed_run(torch, lambda: fn(f))
            runs.append(lc)
            outs.append(r)
            total += ms
        return outs, total

    for kind, run, own in (
            ("solve", lambda: fs.solve(src),
             lambda f: solvers[f].solve(int(src[f]))),
            ("solve_batch [8, 8]", lambda: fs.solve_batch(batch),
             lambda f: solvers[f].solve_batch(batch[f]))):
        res, ms, lc = timed_run(torch, run)
        runs.append(lc)
        if kind == "solve":
            cold_fleet = res
        refs, ref_ms = per_graph(kind, own)
        rmax = int(res.rounds.max())
        for f in range(F):
            if kind == "solve":
                ok = same(torch, res.result(f), refs[f])
            else:
                ok = all(same(torch, res.result(f, i), refs[f][i])
                         for i in range(batch.shape[1]))
            check(ok, f"[fleet] {kind}: member {f} differs from its "
                      "per-graph segment solve")
        check(res.host_syncs == rmax + 2, f"[fleet] {kind}: "
              f"{res.host_syncs} host reads in {rmax} rounds (want rounds "
              "+ 2 at any F)")
        log(f"  segment fleet {kind}: {ms:.1f} ms against {ref_ms:.1f} ms "
            f"for the 8 per-graph solves ({ms / ref_ms:.3f}); rounds "
            f"{rmax} (members {res.rounds.min()}-{rmax}), host reads "
            f"{res.host_syncs} (rounds + 2; per-graph "
            f"{[r.host_syncs for r in refs]}), launches {nonzero(lc)}; "
            "every member bitwise its per-graph solve")

    deltas = [sssp.random_delta(members[f], 128 + 32 * f, seed=100 + f)
              for f in range(F)]
    stacked = sssp.stack_deltas(deltas)
    stats, up_ms, lc = timed_run(torch, lambda: fs.update(stacked))
    runs.append(lc)
    res = fs.resolve()
    colds, cold_ms = per_graph("cold", lambda f: sssp.Solver(
        fs.fleet.member(f), backend="segment").solve(int(src[f])))
    for f in range(F):
        r = res.result(f)
        check(torch.equal(r.dist, colds[f].dist)
              and torch.equal(r.C, colds[f].C)
              and torch.equal(r.fixed, colds[f].fixed),
              f"[fleet] update: member {f} differs from a cold solve of "
              "its mutated graph")
    log(f"  segment fleet update ({stacked.k} edges, {stacked.ks[0]}-"
        f"{stacked.ks[-1]} a member): {up_ms:.1f} ms against "
        f"{cold_ms:.1f} ms for 8 cold per-graph solves; warm rounds "
        f"{stats['warm_rounds']}, sweeps {stats['sweeps']}, tainted "
        f"{stats['tainted']}, host reads {stats['host_syncs']}; every "
        "member bitwise a cold solve of its mutated graph")

    front = sssp.FleetSolver(sssp.GraphFleet.stack(members[:2]),
                             backend="frontier")
    fr, f_ms, lc = timed_run(torch, lambda: front.solve(src[:2]))
    runs.append(lc)
    check(all(same(torch, fr.result(f), cold_fleet.result(f))
              for f in range(2)), "[fleet] the frontier fleet differs from "
                                  "the segment fleet's rows")
    check(lc["frontier_relax_csr"] > 0, "[fleet] the frontier fleet "
                                        "launched no B2")
    log(f"  frontier fleet of 2 members (cap {front.frontier_cap}): "
        f"{f_ms:.1f} ms, rounds {fr.rounds.tolist()}, edges_relaxed "
        f"{fr.edges_relaxed.tolist()}, host reads {fr.host_syncs}, "
        f"launches {nonzero(lc)}; bitwise the segment fleet's rows")
    del fs, front, fleet, members, solvers, res, colds, cold_fleet
    torch.cuda.empty_cache()

    def replay(fault, manager=None):
        fl = sssp.build_fleet([gen.grid(REPLAY_SIDE, seed=f)
                               for f in range(F)])
        rp = CongestionReplay(sssp.FleetSolver(fl), seed=5, ckpt_every=4,
                              queries_per_tick=4, fault=fault,
                              straggler_z=2.0, manager=manager)
        t0 = time.perf_counter()
        stats = rp.run(6)
        return rp, stats, time.perf_counter() - t0
    (clean, _, c_s), _, lc_c = timed_run(torch, lambda: replay(None))
    (chaos, st, x_s), _, lc_x = timed_run(torch, lambda: replay(
        FaultInjector({3: ("dropout", 0), 4: ("straggler", 200)})))
    runs += [lc_c, lc_x]
    ok = (np.array_equal(clean.weights(), chaos.weights())
          and np.array_equal(clean.distances(), chaos.distances()))
    log(f"  CongestionReplay {F} grids side {REPLAY_SIDE}, 6 ticks: "
        f"fault-free {c_s:.2f} s ({6 / c_s:.3f} ticks/s); dropout at tick "
        f"3 + straggler at tick 4: {x_s:.2f} s, {st['ticks']} ticks run "
        f"({st['ticks'] / x_s:.3f} ticks/s), restarts {st['restarts']}, "
        f"stragglers flagged {st['stragglers_flagged']}, queries "
        f"{st['queries']}, cache hits {st['cache_hits']}, fleet dispatches "
        f"{st['fleet_dispatches']}; weights and distances bitwise the "
        f"fault-free replay's: {ok}")
    check(ok, "[fleet] the replay after a dropout differs from the "
              "fault-free replay")
    check(st["restarts"] == 1 and st["stragglers_flagged"] >= 1,
          f"[fleet] replay stats {st}")
    with tempfile.TemporaryDirectory() as ckpt:
        manager = CheckpointManager(ckpt, keep=2)
        (disk, st, d_s), _, lc_d = timed_run(torch, lambda: replay(
            FaultInjector({3: ("dropout", 0)}), manager))
        steps = manager.steps()
    runs.append(lc_d)
    ok = (np.array_equal(clean.weights(), disk.weights())
          and np.array_equal(clean.distances(), disk.distances()))
    log(f"  CongestionReplay on disk (CheckpointManager, keep 2), dropout "
        f"at tick 3: {d_s:.2f} s, {st['ticks']} ticks run, restarts "
        f"{st['restarts']}, checkpoints kept {steps}; weights and "
        f"distances bitwise the fault-free replay's: {ok}")
    check(ok and st["restarts"] == 1, "[fleet] the on-disk replay after a "
                                      "dropout differs from the fault-free "
                                      "replay")
    return runs


# ---------------------------------------------------------------------------
# serving, the launcher and the baselines
# ---------------------------------------------------------------------------

SERVE_HOT = 32                # the launcher's pool of popular sources
SERVE_QUERIES = 96            # scalar-target queries a [serve] wave
SERVE_FULL = 8                # full-vector queries a [serve] wave
SERVE_WAVES = 3               # apply_delta between waves (seeds 11, 12)
SCIPY_WORKERS = 6             # [serve]'s scipy Dijkstra runs beside it
LAUNCH_N = 1 << 14            # the launcher's grid runs (--verify: Python)
# the modules a solve or a served wave runs in: a host sync there that no
# SyncCounter counts is a fault ([parity] fails on one)
ENGINE_FILES = ("engine.py", "solver.py", "backends.py", "sssp_service.py",
                "planner.py", "bellman_ford.py", "delta_stepping.py",
                "ops.py", "relax.py", "segment_min.py", "frontier_relax.py")


def observed(torch, fn):
    """``fn()`` once on the card under torch's sync debug mode, on the host
    clock ending in a synchronize, with every launch count set to 0 just
    before and read just after and every ``SyncCounter`` read (the
    engine's and the service's) tallied: (its result, ms, the launch
    counts, the counted reads, the sites of the syncs no counter saw)."""
    from repro_torch.core.sssp import engine
    from repro_torch.kernels import _build
    orig = engine.SyncCounter._read
    reads = [0]

    def tally(self, t, how):
        reads[0] += 1
        return orig(self, t, how)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    engine.SyncCounter._read = tally
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    finally:
        engine.SyncCounter._read = orig
    hidden = [f"{Path(c.filename).name}:{c.lineno}" for c in caught
              if "synchroniz" in str(c.message)]
    return out, ms, _build.launch_counts(), reads[0], hidden


def sites(hidden) -> dict:
    """Uncounted sync sites with their counts."""
    return dict(collections.Counter(hidden))


_SCIPY: dict = {}    # a [serve] scipy worker's graph, set once a process


def _scipy_init(n, src, dst):
    _SCIPY["graph"] = (n, src, dst)


def _scipy_pick(w, sources, targets, full):
    """In a worker: scipy's float64 Dijkstra from ``sources`` with weights
    ``w``; per source its distances at ``targets[i]`` and, for sources in
    ``full``, the whole row."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    n, src, dst = _SCIPY["graph"]
    m = csr_matrix((np.asarray(w, np.float64), (src, dst)), shape=(n, n))
    rows = dijkstra(m, directed=True, indices=list(sources))
    return [(s, rows[i][np.asarray(targets[i], np.int64)],
             rows[i] if s in full else None) for i, s in enumerate(sources)]


def near(got, want) -> bool:
    """f32 answers against float64 ones: unreachable alike, else within
    rtol 1e-4 (atol 1e-5), the tolerance of every scipy check here."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    return bool(np.array_equal(np.isinf(got), np.isinf(want))
                and np.allclose(got[fin], want[fin], rtol=1e-4, atol=1e-5))


def serve_phase(torch, pt):
    """The SSSP query service at n = 2^20 through
    ``SSSPService(gnp, backend="pallas", batch=8, landmarks=8,
    planner=True, bidirectional=True, reselect=0.5)``: 3 waves of 96
    scalar-target queries (a pool of 32 hot sources, uniform targets,
    rng seed 0, as the launcher draws them) and 8 full-vector queries,
    with ``apply_delta`` of ``[dynamic]``'s delta (1,024 random edges x
    uniform[0.5, 2.0], seeds 11 and 12) between waves.  Per wave: ms and
    queries/s, routes, cache hits, batches, targeted and bidirectional
    solves, B3/B4 launches and host reads (counted, the service's own,
    and uncounted under sync debug mode).  Every full vector and every
    scalar answer not from the pair cache is bitwise ``dist[t]`` of a cold
    segment ``solve_batch`` of the current graph version; pair-cache
    (bidirectional) answers are paths of real edges folding to the
    distance within rtol 1e-4 of it; every answer is within rtol 1e-4 of
    scipy's float64 Dijkstra (run in worker processes beside the card).
    Returns the launch counts of every run."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.runtime.sssp_service import Query, SSSPService
    sssp = pt["sssp"]
    n, src, dst, w = graph_arrays(pt, "gnp")
    g = sssp.build_graph(n, src, dst, w, device=DEVICE)
    e = g.e
    hsrc = g.src[:e].cpu().numpy()
    hdst = g.dst[:e].cpu().numpy()
    key = hsrc.astype(np.int64) * n + hdst
    order = np.argsort(key, kind="stable")   # edge_table's, any weights
    key = key[order]
    runs = []
    svc, build_ms, lc = timed_run(torch, lambda: SSSPService(
        g, backend="pallas", batch=8, landmarks=8, planner=True,
        bidirectional=True, reselect=0.5, device=DEVICE))
    runs.append(lc)
    log(f"  SSSPService(gnp n={n} e={e}, pallas, batch 8, 8 landmarks "
        f"on {svc.landmarks._fwd.backend}, planner, bidirectional on "
        f"{svc._bidi.backend}, reselect 0.5) built in {build_ms:.1f} ms, "
        f"launches {nonzero(lc)}")
    check(svc.solver.backend == "pallas" and svc._bidi.backend == "segment",
          f"[serve] routes {svc.solver.backend} / {svc._bidi.backend}")
    rng = np.random.default_rng(0)
    hot = rng.choice(n, size=SERVE_HOT, replace=False)
    pool = concurrent.futures.ProcessPoolExecutor(
        SCIPY_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_scipy_init, initargs=(n, hsrc, hdst))
    pending = []
    totals = dict(ms=0.0, queries=0)
    try:
        for wave in range(SERVE_WAVES):
            qs = [Query(int(rng.choice(hot)), int(rng.integers(0, n)))
                  for _ in range(SERVE_QUERIES)]
            qs += [Query(int(rng.choice(hot))) for _ in range(SERVE_FULL)]
            before = copy.deepcopy(svc.stats)
            reads0 = svc.host_reads
            _, ms, lc, reads, hidden = observed(torch, lambda: svc.serve(qs))
            runs.append(lc)
            st = svc.stats
            routes = {k: v - before["planner_routes"][k]
                      for k, v in st["planner_routes"].items()}
            diff = {k: st[k] - before[k] for k in (
                "cache_hits", "batches", "p2p_solves", "bidi_solves",
                "sources_solved")}
            totals["ms"] += ms
            totals["queries"] += len(qs)
            log(f"  wave {wave} (graph v{svc.version}): {len(qs)} queries in "
                f"{ms:.1f} ms ({len(qs) / ms * 1e3:.1f} queries/s); routes "
                f"{routes}; {diff}; B3 {lc['relax_ell']}, B4 "
                f"{lc['masked_min_pair']} launches; host reads {reads} "
                f"counted ({svc.host_reads - reads0} the service's own), "
                f"{len(hidden)} uncounted {sites(hidden)}; reselects "
                f"{st['reselects']}, seed tightness "
                f"{st['seed_tightness_mean']}")
            check(all(q.done for q in qs), f"[serve] wave {wave}: a query "
                                           "was not answered")
            check(diff["batches"] == 0 or (lc["relax_ell"] > 0
                                           and lc["masked_min_pair"] > 0),
                  f"[serve] wave {wave}: {diff['batches']} pallas solves "
                  "launched no B3 or B4")
            # a cold segment solve of this graph version, every source
            cur = svc.solver.graph
            cold = sssp.Solver(cur, backend="segment", device=DEVICE)
            srcs = sorted({q.source for q in qs})
            rows = {}
            for at in range(0, len(srcs), 8):
                b = cold.solve_batch(srcs[at: at + 8])
                rows.update({s: b.dist[i] for i, s in
                             enumerate(srcs[at: at + 8])})
            scal = [q for q in qs if q.target is not None]
            want = torch.stack([rows[q.source][q.target] for q in scal]
                               ).cpu().numpy()
            w_now = cur.w[:e].cpu().numpy()
            table = (n, key, w_now[order])
            bitwise = pair_ans = pair_bitwise = 0
            for q, wt in zip(scal, want):
                same_bits = np.float32(q.distance).tobytes() == wt.tobytes()
                entry = svc._pairs.get((q.source, q.target))
                from_pair = (entry is not None and entry[0] == svc.version
                             and entry[1] == q.distance)
                if from_pair:
                    pair_ans += 1
                    pair_bitwise += int(same_bits)
                    if np.isfinite(wt):
                        fold = edge_fold(table, q.path)
                        check(q.path[0] == q.source
                              and q.path[-1] == q.target and fold is not None
                              and fold.tobytes()
                              == np.float32(q.distance).tobytes()
                              and abs(q.distance - float(wt))
                              <= 1e-4 * abs(float(wt)),
                              f"[serve] wave {wave}: the bidirectional "
                              f"answer ({q.source}, {q.target}) "
                              f"{q.distance!r} against dist[t] {wt!r}")
                    else:
                        check(not np.isfinite(q.distance) and q.path is None,
                              f"[serve] ({q.source}, {q.target}) reachable")
                else:
                    check(same_bits, f"[serve] wave {wave}: the answer "
                          f"({q.source}, {q.target}) {q.distance!r} is not "
                          f"dist[t] {wt!r} of a cold segment solve")
                    bitwise += 1
            for q in qs:
                if q.target is None:
                    check(np.array_equal(q.dist,
                                         rows[q.source].cpu().numpy()),
                          f"[serve] wave {wave}: the full vector of "
                          f"{q.source} differs from a cold segment solve")
            log(f"    answers: {bitwise} bitwise dist[t] of a cold segment "
                f"solve (targeted, full, cache); {pair_ans} from the "
                f"bidirectional pair cache, {pair_bitwise} of them bitwise "
                f"dist[t], every one a path of real edges folding to its "
                f"distance, within rtol 1e-4; {SERVE_FULL} full vectors "
                "bitwise")
            by_src: dict = {}
            for q in scal:
                by_src.setdefault(q.source, []).append(q.target)
            full = {q.source for q in qs if q.target is None}
            srcs = sorted(set(by_src) | full)
            chunks = [srcs[i::SCIPY_WORKERS] for i in range(SCIPY_WORKERS)]
            for c in chunks:
                if c:
                    pending.append((wave, list(qs), pool.submit(
                        _scipy_pick, w_now, c,
                        [by_src.get(s, []) for s in c], full)))
            del rows, cold, want
            if wave + 1 < SERVE_WAVES:
                delta = sssp.random_delta(svc.solver.graph, 1024,
                                          seed=11 + wave)
                pw0 = svc.stats["pair_warm_refreshed"]
                stats, ms, lc, reads, hidden = observed(
                    torch, lambda: svc.apply_delta(delta))
                runs.append(lc)
                log(f"  apply_delta v{svc.version} (1024 edges, seed "
                    f"{11 + wave}): {ms:.1f} ms; warm_refreshed "
                    f"{stats['warm_refreshed']} (cold "
                    f"{stats['cold_refreshed']}), pair_warm_refreshed "
                    f"{svc.stats['pair_warm_refreshed'] - pw0}; host reads "
                    f"{reads} counted, {len(hidden)} uncounted (host-built "
                    f"remapped deltas, the refold's weights) "
                    f"{sites(hidden)}; launches {nonzero(lc)}")
        worst = 0.0
        for wave, qs, job in pending:
            got = {q.source: [] for q in qs}
            for q in qs:
                if q.target is not None:
                    got[q.source].append(q.distance)
            for s, d_t, row in job.result():
                check(near(got[s], d_t), f"[serve] wave {wave}: answers "
                      f"from {s} are not within rtol 1e-4 of scipy")
                fin = np.isfinite(d_t) & (d_t > 0)
                if fin.any():
                    worst = max(worst, float(np.max(np.abs(
                        np.asarray(got[s])[fin] - d_t[fin]) / d_t[fin])))
                if row is not None:
                    for q in qs:
                        if q.source == s and q.target is None:
                            check(near(q.dist, row), f"[serve] wave {wave}:"
                                  f" the full vector of {s} is not within "
                                  "rtol 1e-4 of scipy")
    finally:
        pool.shutdown(cancel_futures=True)
    st = svc.stats
    log(f"  [serve] {totals['queries']} queries in {totals['ms']:.1f} ms of "
        f"waves ({totals['queries'] / totals['ms'] * 1e3:.1f} queries/s); "
        f"solve_seconds {st['solve_seconds']:.3f}, delta_seconds "
        f"{st['delta_seconds']:.3f}; routes {st['planner_routes']}; every "
        f"answer within rtol 1e-4 of scipy (largest scalar rel err "
        f"{worst:.3e})")
    del svc, g
    torch.cuda.empty_cache()
    return runs


def launcher_phase(torch, pt):
    """``repro_torch.launch.serve_sssp.main`` in process on the card, on
    grid n = 2^14 with ``--verify`` (16 answers against the port's
    Python Dijkstra): ``--landmarks 4 --deltas 1`` (``auto`` -> frontier:
    the targeted waves launch B2) and ``--bidirectional`` (every miss
    meets in the middle on the frontier route: B1 twice a round).  rc 0
    required.  Returns the launch counts of both runs."""
    from repro_torch.launch import serve_sssp
    runs = []
    base = ["--family", "grid", "--n", str(LAUNCH_N), "--batch", "8",
            "--device", DEVICE, "--verify"]
    for extra, need in ((["--queries", "64", "--landmarks", "4",
                          "--deltas", "1"], "frontier_relax_csr"),
                        (["--queries", "32", "--bidirectional"],
                         "frontier_relax")):
        args = base + extra
        rc, ms, lc = timed_run(torch, lambda: serve_sssp.main(args))
        runs.append(lc)
        log(f"  serve_sssp {' '.join(args)}: rc {rc}, {ms:.1f} ms, B1 "
            f"{lc['frontier_relax']}, B2 {lc['frontier_relax_csr']} "
            f"launches; all {nonzero(lc)}")
        check(rc == 0, f"serve_sssp {' '.join(args)} returned {rc}")
        check(lc[need] > 0, f"serve_sssp {' '.join(extra)}: no {need} "
                            "launched")
    return runs


def baselines_phase(torch, pt, main_runs):
    """Bellman-Ford and Δ-stepping (Δ = 0.25, 1.0) from the main path's
    first source on gnp 2^20 and grid side 1024: rounds, phases, light
    iterations, ms and host reads; each ``dist`` bitwise the main path's
    SP4 ``dist`` for that source (every exact algorithm here ends at the
    same f32 fixpoint), and Bellman-Ford's within rtol 1e-4 of scipy.
    Returns the launch counts of every run."""
    sssp = pt["sssp"]
    runs = []
    for name, key in (("gnp", "gnp/segment"), ("grid", "grid/frontier")):
        sp4 = main_runs[key]["solve"]
        s0 = sp4["res"].source
        n, src, dst, w = graph_arrays(pt, name)
        g = sssp.build_graph(n, src, dst, w, device=DEVICE)
        for what, fn in (
                ("Bellman-Ford", lambda: sssp.run_bellman_ford(g, s0)),
                ("delta-stepping 0.25", lambda: sssp.run_delta_stepping(
                    g, s0, delta=0.25)),
                ("delta-stepping 1.0", lambda: sssp.run_delta_stepping(
                    g, s0, delta=1.0))):
            res, ms, lc = timed_run(torch, fn)
            runs.append(lc)
            depth = (f"rounds {res.rounds}" if what == "Bellman-Ford" else
                     f"phases {res.phases}, light iterations "
                     f"{res.light_iters}")
            ok = torch.equal(res.dist, sp4["res"].dist)
            log(f"  {name} {what} from {s0}: {ms:.1f} ms, {depth}, host "
                f"reads {res.host_syncs}; SP4 {sp4['ms']:.1f} ms in "
                f"{sp4['rounds']} rounds; dist bitwise SP4's: {ok}")
            check(ok, f"[baselines] {name} {what}: dist differs from the "
                      "main path's SP4 dist")
            if what == "Bellman-Ford":
                check(res.host_syncs == res.rounds, f"[baselines] {name}: "
                      f"{res.host_syncs} host reads in {res.rounds} rounds")
                against_scipy(torch, [res.dist], n, src, dst, w, [s0],
                              f"[baselines] {name} Bellman-Ford")
            else:
                check(res.host_syncs == res.phases + 1 + res.light_iters,
                      f"[baselines] {name} {what}: {res.host_syncs} host "
                      "reads")
        del g
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# the distributed backend and the legacy entry points
# ---------------------------------------------------------------------------

DIST_WORLDS = (2, 4)          # gloo ranks sharing the one card
DIST_GRID_SIDE = 256          # [distributed]'s grid solve at world 2
RANK_DEADLINE = 600.0         # seconds a spawned group may take in all
TRACE_N = 1 << 14             # [legacy]'s traced gnp
TRACE_GRID_SIDE = 128         # [legacy]'s traced grid, n = 2^14


def digest(*tensors) -> str:
    """sha256 of the tensors' dtypes, shapes and bytes: two results are
    bitwise equal when their digests are."""
    h = hashlib.sha256()
    for t in tensors:
        a = t.detach().cpu().numpy()
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def result_digest(res) -> dict:
    """A solve's or batch's dist, C, fixed (digests), rounds, fixed_by."""
    return dict(dist=digest(res.dist), C=digest(res.C),
                fixed=digest(res.fixed),
                rounds=np.asarray(res.rounds).tolist(),
                fixed_by=res.fixed_by)


def dist_rank(rank, world, spec):
    """One gloo rank of ``[distributed]`` on the card (cuda:0, shared with
    the other ranks; ``spec`` names the device and the sizes): builds its
    graphs from the generators (no tensor crosses processes), runs the
    distributed ``Solver`` (and at world 2 the ``DynamicSolver`` update
    and the grid solve), and returns host values: digests, rounds, times
    and the collectives' counts."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import sssp
    from repro_torch.core import generators as gen
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)

    def run(solver, fn, extra=None):
        solver.collectives.reset()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out = dict(ms=ms, calls=solver.collectives.calls,
                   bytes=solver.collectives.bytes,
                   coll_ms=solver.collectives.ms())
        out.update(extra(res) if extra else result_digest(res))
        return out

    out = {}
    n, src, dst, w = gen.gnp(spec["gnp_n"], avg_deg=8.0, seed=0)
    g = sssp.build_graph(n, src, dst, w, device=dev)
    solver = sssp.Solver(g, backend="distributed", device=dev)
    solver.collectives.timed = True
    out["world"], out["rank"] = solver.world, solver.rank
    out["solve"] = run(solver, lambda: solver.solve(spec["s0"]))
    out["solve_batch"] = run(solver,
                             lambda: solver.solve_batch(spec["batch"]))
    if spec["dynamic"]:
        dyn = sssp.DynamicSolver(g, backend="distributed", device=dev)
        dyn.collectives.timed = True
        dyn.solve_batch(spec["dyn_sources"])
        delta = sssp.random_delta(dyn.graph, 1024, seed=11)  # [dynamic]'s
        keep = {}

        def update():
            keep["stats"] = dyn.update(delta)
            return dyn.resolve(spec["dyn_sources"])
        out["update"] = run(dyn, update, lambda r: dict(
            dist_fixed=digest(r.dist, r.fixed),
            rounds=keep["stats"]["warm_rounds"],
            sweeps=keep["stats"]["sweeps"]))
        del dyn
    del solver, g
    if spec["grid"]:
        n, src, dst, w = gen.grid(spec["grid_side"], seed=0)
        grid = sssp.Solver(sssp.build_graph(n, src, dst, w, device=dev),
                           backend="distributed", device=dev)
        grid.collectives.timed = True
        out["grid"] = run(grid, lambda: grid.solve(spec["grid_source"]))
    return out


def distributed_phase(torch, pt, main_runs, dyn_ref):
    """The distributed backend at the main path's width (gnp 2^20).
    World 1: a one-rank NCCL group in this process, ``solve`` and
    ``solve_batch(8)`` of the main path's sources under torch's sync
    debug mode (no uncounted sync), bitwise the main path's segment
    results, exactly ``1 + c_prop_iters`` all-reduces a round.  Worlds 2
    and 4: gloo ranks spawned on the one card (``spawn_ranks``, a
    deadline of ``RANK_DEADLINE``), the same solves bitwise, every rank
    bitwise every other; at world 2 also ``[dynamic]``'s gnp update
    (bitwise its cold re-solve of the mutated graph) and a grid of side
    256 (bitwise a segment solve here).  Logs each world's rounds' ms
    and its all-reduces' ms and bytes a round.  Returns the launch
    counts of the world-1 runs."""
    import datetime
    import tempfile
    import torch.distributed as dist
    from repro_torch.distributed.ranks import spawn_ranks
    sssp, gen = pt["sssp"], pt["generators"]
    per_round = 1 + sssp.SP4_CONFIG.c_prop_iters
    want = {k: result_digest(main_runs["gnp/segment"][k]["res"])
            for k in ("solve", "solve_batch")}
    s0 = main_runs["gnp/segment"]["solve"]["res"].source
    batch = [int(v) for v in main_runs["gnp/segment"]["solve_batch"][
        "res"].sources]
    runs = []

    def report(world, kind, r):
        rounds = max(np.atleast_1d(r["rounds"]))
        log(f"  world {world} {kind}: {r['ms']:.1f} ms, rounds {rounds}, "
            f"{r['ms'] / max(rounds, 1):.3f} ms a round; all-reduces "
            f"{r['calls']} ({r['calls'] / max(rounds, 1):.2f} a round), "
            f"{r['bytes'] / max(r['calls'], 1) / 2 ** 20:.2f} MiB each, "
            f"{r['coll_ms']:.1f} ms in all, "
            f"{r['coll_ms'] / max(rounds, 1):.3f} ms a round")
        return rounds

    with tempfile.TemporaryDirectory() as tmp:
        # --- world 1: a one-rank NCCL group --------------------------
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/nccl", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=300))
        try:
            warm = torch.zeros(1, device=DEVICE)
            dist.all_reduce(warm, op=dist.ReduceOp.MIN)  # communicator
            torch.cuda.synchronize()
            n, src, dst, w = graph_arrays(pt, "gnp")
            g = sssp.build_graph(n, src, dst, w, device=DEVICE)
            solver = sssp.Solver(g, backend="distributed")
            solver.collectives.timed = True
            check(solver.world == 1 and solver.group is not None,
                  f"[distributed] world {solver.world}, group "
                  f"{solver.group}: not the one-rank NCCL group")
            for kind, fn in (("solve", lambda: solver.solve(s0)),
                             ("solve_batch",
                              lambda: solver.solve_batch(batch))):
                solver.collectives.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res, lc, hidden = sync_debugged(torch, fn)
                torch.cuda.synchronize()
                r = dict(ms=(time.perf_counter() - t0) * 1e3,
                         calls=solver.collectives.calls,
                         bytes=solver.collectives.bytes,
                         coll_ms=solver.collectives.ms(),
                         **result_digest(res))
                runs.append(lc)
                rounds = report(1, kind, r)
                check(all(r[k] == want[kind][k] for k in want[kind]),
                      f"[distributed] world 1 {kind} differs from the "
                      "main path's segment result")
                check(r["calls"] == rounds * per_round,
                      f"[distributed] world 1 {kind}: {r['calls']} "
                      f"all-reduces in {rounds} rounds")
                check(not hidden, f"[distributed] world 1 {kind}: host "
                                  f"syncs the engine does not count at "
                                  f"{hidden}")
            log("  world 1 (NCCL): solve and solve_batch(8) bitwise the "
                "main path's segment results; no uncounted sync")
            # where the checked solve's time went: the same solve again
            # under the checked run's conditions, then without sync debug
            # mode, then without the all-reduces' events, then a segment
            # solve of the same graph in this process
            seg = sssp.Solver(g, backend="segment")

            def again(fn, debug, timed):
                solver.collectives.reset()
                solver.collectives.timed = timed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if debug:
                    sync_debugged(torch, fn)
                else:
                    fn()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3
            ms = [again(lambda: solver.solve(s0), True, True),
                  again(lambda: solver.solve(s0), False, True),
                  again(lambda: solver.solve(s0), False, False),
                  again(lambda: seg.solve(s0), False, False)]
            log(f"  world 1 solve again: sync debug mode and events "
                f"{ms[0]:.1f} ms, events {ms[1]:.1f} ms, neither "
                f"{ms[2]:.1f} ms; a segment solve here {ms[3]:.1f} ms")
            del seg
            del solver, g
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

        # --- worlds 2 and 4: gloo ranks sharing the card ---------------
        n, src, dst, w = gen.grid(DIST_GRID_SIDE, seed=0)
        grid_source = int(np.random.default_rng(2024).integers(n))
        grid_want = result_digest(sssp.Solver(
            sssp.build_graph(n, src, dst, w, device=DEVICE),
            backend="segment").solve(grid_source))
        for world in DIST_WORLDS:
            spec = dict(device=DEVICE, gnp_n=GNP_N, s0=s0, batch=batch,
                        dynamic=world == 2, dyn_sources=dyn_ref["sources"],
                        grid=world == 2, grid_side=DIST_GRID_SIDE,
                        grid_source=grid_source)
            t0 = time.perf_counter()
            outs = spawn_ranks(dist_rank, world, (spec,), init_dir=tmp,
                               timeout=300.0, deadline=RANK_DEADLINE)
            log(f"  world {world} (gloo, {world} ranks on one card): "
                f"{time.perf_counter() - t0:.1f} s with start-up")
            check([o["world"] for o in outs] == [world] * world
                  and [o["rank"] for o in outs] == list(range(world)),
                  f"[distributed] world {world}: ranks report "
                  f"{[(o['rank'], o['world']) for o in outs]}")
            kinds = [("solve", want["solve"]),
                     ("solve_batch", want["solve_batch"])]
            if world == 2:
                kinds += [("update", dict(dist_fixed=dyn_ref["dist_fixed"])),
                          ("grid", grid_want)]
            for kind, ref_digest in kinds:
                rounds = report(world, kind, outs[0][kind])
                for o in outs:
                    check(all(o[kind][k] == ref_digest[k]
                              for k in ref_digest),
                          f"[distributed] world {world} rank {o['rank']} "
                          f"{kind} differs from the single-device result")
                    check(all(o[kind][k] == outs[0][kind][k]
                              for k in ("dist", "C", "fixed", "dist_fixed",
                                        "rounds", "fixed_by", "calls")
                              if k in o[kind]),
                          f"[distributed] world {world}: rank "
                          f"{o['rank']} differs from rank 0 ({kind})")
                    if kind != "update":
                        check(o[kind]["calls"] == rounds * per_round,
                              f"[distributed] world {world} {kind}: "
                              f"{o[kind]['calls']} all-reduces in "
                              f"{rounds} rounds")
            upd = outs[0].get("update")
            if upd is not None:
                log(f"  world {world} update: sweeps {upd['sweeps']}, warm "
                    f"rounds {upd['rounds']}; bitwise [dynamic]'s cold "
                    "re-solve of the mutated graph")
            log(f"  world {world}: every rank bitwise the single-device "
                "results and every other rank")
    return runs


def legacy_phase(torch, pt, main_runs):
    """The legacy entry points.  ``run_sssp`` and ``run_sssp_ell`` from
    the main path's first gnp source at n = 2^20, bitwise its segment
    and pallas ``solve``, ``run_sssp_ell`` launching B3 three times and
    B4 once a round.  ``run_sssp_traced`` on gnp 2^14 and a grid of
    side 128: every round's C <= scipy's cost <= D (rtol 1e-4), C rising
    and D falling (within the reference test's 1e-6), and the card's
    trace bitwise the port's CPU trace, key by key, round by round.
    Returns the launch counts of every counted run."""
    sssp, gen = pt["sssp"], pt["generators"]
    runs = []
    n, src, dst, w = graph_arrays(pt, "gnp")
    g = sssp.build_graph(n, src, dst, w, device=DEVICE)
    seg = main_runs["gnp/segment"]["solve"]
    pal = main_runs["gnp/pallas"]["solve"]
    s0 = seg["res"].source
    res, ms, lc = timed_run(torch, lambda: sssp.run_sssp(g, s0))
    runs.append(lc)
    check(same(torch, res, seg["res"]), "[legacy] run_sssp differs from "
                                        "the main path's segment solve")
    log(f"  run_sssp gnp 2^20 from {s0}: {ms:.1f} ms, rounds {res.rounds}, "
        f"host reads {res.host_syncs}; bitwise the segment solve "
        f"({seg['ms']:.1f} ms)")
    ell = sssp.build_ell(n, src, dst, w, device=DEVICE)
    res, ms, lc = timed_run(torch, lambda: sssp.run_sssp_ell(g, ell, s0))
    runs.append(lc)
    check(same(torch, res, pal["res"]), "[legacy] run_sssp_ell differs "
                                        "from the main path's pallas solve")
    check(lc["relax_ell"] == 3 * res.rounds
          and lc["masked_min_pair"] == res.rounds,
          f"[legacy] run_sssp_ell launched B3 {lc['relax_ell']} and B4 "
          f"{lc['masked_min_pair']} times in {res.rounds} rounds (want 3 "
          "and 1 a round)")
    log(f"  run_sssp_ell gnp 2^20: {ms:.1f} ms, rounds {res.rounds}, "
        f"launches {nonzero(lc)} (B3 3 a round, B4 1); bitwise the pallas "
        f"solve ({pal['ms']:.1f} ms)")
    del g, ell
    torch.cuda.empty_cache()
    for name, (nn, src, dst, w) in (
            ("gnp 2^14", gen.gnp(TRACE_N, avg_deg=8.0, seed=0)),
            (f"grid side {TRACE_GRID_SIDE}", gen.grid(TRACE_GRID_SIDE,
                                                      seed=0))):
        gc = sssp.build_graph(nn, src, dst, w, device=DEVICE)
        res, ms, lc = timed_run(torch, lambda: sssp.run_sssp_traced(gc, 0))
        runs.append(lc)
        cpu = sssp.run_sssp_traced(
            sssp.build_graph(nn, src, dst, w, device="cpu"), 0)
        cost = scipy_dist(nn, src, dst, w, [0])[0]
        tol = 1e-4 * np.where(np.isinf(cost), 0.0, cost)
        bounds = all((t["C"] <= cost + tol).all()
                     and (cost <= t["D"] + tol).all() for t in res.trace)
        mono = all((t["C"] >= t["prev_C"] - 1e-6).all()
                   and (t["D"] <= t["prev_D"] + 1e-6).all()
                   for t in res.trace)
        ok = same_rows(res.trace, cpu.trace)
        log(f"  run_sssp_traced {name}: {ms:.1f} ms, {len(res.trace)} "
            f"rounds, host reads {res.host_syncs}; C <= cost <= D every "
            f"round: {bounds}; C up, D down: {mono}; card trace == CPU "
            f"trace: {ok}")
        check(bounds and mono, f"[legacy] {name}: a traced round breaks "
                               "the bounds invariants")
        check(ok and len(res.trace) == res.rounds > 0,
              f"[legacy] {name}: the card's trace differs from the CPU's")
    return runs


def serve_parity_runs(torch, sssp, gen, n, device, wrap):
    """``[parity]``'s service and baseline runs on ``device``, each group
    through ``wrap`` (as ``parity_runs``).  A planned service
    (``WavePlanner(margin=1e30)``, 4 landmarks, bidirectional) on the
    grid via "auto" (frontier) and on gnp via "pallas": a wave of 30
    scalar and 2 full-vector queries, ``apply_delta`` of 64 random edges,
    a second wave; answers (f32 bits, paths, vectors), every stat but the
    timers, the delta's stats and the service's own reads.  Then
    Bellman-Ford and Δ-stepping (0.25, 1.0) from 2 sources on gnp.
    Returns ``{(kind, route): (rows, launches, uncounted)}``."""
    from repro_torch.runtime.planner import WavePlanner
    from repro_torch.runtime.sssp_service import Query, SSSPService
    out = {}
    for family, be in (("grid", "auto"), ("gnp", "pallas")):
        nn, src, dst, w = gen.make(family, n, seed=1)
        g = sssp.build_graph(nn, src, dst, w, device=device)
        rng = np.random.default_rng(7)
        hot = rng.choice(nn, 8, replace=False)
        waves = [[(int(rng.choice(hot)), int(rng.integers(nn)))
                  for _ in range(30)] + [(int(rng.choice(hot)), None)] * 2
                 for _ in range(2)]
        delta = sssp.random_delta(g, 64, seed=9)
        svc = SSSPService(g, backend=be, batch=8, landmarks=4,
                          planner=WavePlanner(margin=1e30),
                          bidirectional=True, device=device)

        def wave(i):
            qs = [Query(s, t) for s, t in waves[i]]
            svc.serve(qs)
            return [(q.source, q.target, None if q.distance is None
                     else np.float32(q.distance).tobytes(), q.path, q.dist)
                    for q in qs]
        rows, launches, hidden = {}, {}, {}
        for part, fn in (("wave 0", lambda: wave(0)),
                         ("delta", lambda: svc.apply_delta(delta)),
                         ("wave 1", lambda: wave(1))):
            rows[part], lc, hidden[part] = wrap(fn)
            for k, v in lc.items():
                launches[k] = launches.get(k, 0) + v
        rows["stats"] = {k: v for k, v in svc.stats.items()
                         if k not in ("solve_seconds", "delta_seconds")}
        rows["reads"] = svc.host_reads
        rows["bidi"] = svc._bidi.backend
        out[("serve", svc.solver.backend)] = (rows, launches, hidden)
        del svc, g
    nn, src, dst, w = gen.make("gnp", n, seed=1)
    g = sssp.build_graph(nn, src, dst, w, device=device)

    def baselines():
        res = []
        for s in (0, nn // 2):
            res.append(sssp.run_bellman_ford(g, s))
            res += [sssp.run_delta_stepping(g, s, delta=d)
                    for d in (0.25, 1.0)]
        return res
    res, lc, hidden = wrap(baselines)
    rows = [dict(dist=r.dist.cpu().numpy(), host_syncs=r.host_syncs,
                 depth=[getattr(r, k, None) for k in (
                     "rounds", "phases", "light_iters")]) for r in res]
    out[("baselines", "gnp")] = (rows, lc, {"runs": hidden})
    return out


def serve_parity_cpu(n):
    """The CPU side of ``serve_parity_runs``, in a worker process."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import sssp
    from repro_torch.core import generators
    torch.set_num_threads(2)
    return serve_parity_runs(torch, sssp, generators, n, "cpu",
                             lambda fn: (fn(), {}, []))


def serve_parity_check(key, a, b, launches, hidden) -> None:
    """One service or baseline group of ``[parity]``: the card's rows
    against the CPU's, no uncounted sync in the waves or the baselines,
    none in the engine's modules during ``apply_delta``, the route's
    kernels launched."""
    kind, be = key
    ok = same_rows(a, b)
    if kind == "serve":
        st = a["stats"]
        log(f"  service {be:8s} (bidirectional {a['bidi']}) card == cpu: "
            f"{ok} (routes {st['planner_routes']}, cache hits "
            f"{st['cache_hits']}, batches {st['batches']}, bidi solves "
            f"{st['bidi_solves']}, pair warm refreshed "
            f"{st['pair_warm_refreshed']}; the service's own reads "
            f"{a['reads']}; launches {launches}; uncounted syncs: waves "
            f"{sites(hidden['wave 0'] + hidden['wave 1'])}, apply_delta "
            f"{sites(hidden['delta'])})")
        check(not hidden["wave 0"] and not hidden["wave 1"],
              f"[parity] service {be}: uncounted host syncs in a wave")
        check(not [h for h in hidden["delta"]
                   if h.split(":")[0] in ENGINE_FILES],
              f"[parity] service {be}: an uncounted host sync in the "
              f"engine during apply_delta: {sites(hidden['delta'])}")
        need = (("frontier_relax_csr", "frontier_relax") if be == "frontier"
                else ("relax_ell", "masked_min_pair"))
        check(all(launches.get(k, 0) > 0 for k in need),
              f"[parity] service {be}: launches {launches}")
    else:
        log(f"  baselines {be} card == cpu: {ok} (rounds / phases / light "
            f"iterations {[r['depth'] for r in a]}, host reads "
            f"{[r['host_syncs'] for r in a]}; uncounted "
            f"{sites(hidden['runs'])})")
        check(not hidden["runs"], "[parity] baselines: uncounted syncs")
    check(ok, f"[parity] {kind} {be}: card and CPU differ")


def profile_phase(torch, pt, rounds: int = 400):
    """Device time by kernel over the first ``rounds`` rounds of each
    main-path route, of a grid bidirectional pair (frontier) and of a
    segment fleet of 8 grids (``torch.profiler``, CUDA activity), the
    device's busy and idle share of the wall time, and launches a
    round."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    gen, sssp = pt["generators"], pt["sssp"]
    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(sssp.SP4_CONFIG, max_rounds=rounds)
    n, src, dst, w = graph_arrays(pt, "grid")
    grid = sssp.build_graph(n, src, dst, w, device=dev)
    n, src, dst, w = graph_arrays(pt, "gnp")
    gnp = sssp.build_graph(n, src, dst, w, device=dev)
    bidi = sssp.BidirectionalSolver(grid, cfg)
    fleet = sssp.FleetSolver(sssp.build_fleet(
        [gen.grid(FLEET_SIDE, seed=f) for f in range(8)]), cfg)
    fleet_what = f"fleet segment (8 grids side {FLEET_SIDE})"
    extra = {"grid bidi frontier": (("solve", lambda: bidi.solve(
        1, grid.n - 1)),),
        fleet_what: (("solve", lambda: fleet.solve(list(range(1, 17, 2)))),)}
    for what, g, be in (("grid frontier", grid, "auto"),
                        ("gnp segment", gnp, "auto"),
                        ("gnp pallas", gnp, "pallas"),
                        ("grid bidi frontier", None, None),
                        (fleet_what, None, None)):
        if g is None:
            kinds = extra[what]
        else:
            solver = sssp.Solver(g, cfg, backend=be)
            kinds = (("solve", lambda: solver.solve(1)),
                     ("solve_batch", lambda: solver.solve_batch(
                         [1, 5, 9, 13, 17, 21, 25, 29])))
        for kind, run in kinds:
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            r = int(np.max(res.rounds))
            kern = _device_events(prof)
            busy = sum(_self_device_us(e) for e in kern)
            count = sum(e.count for e in kern)
            log(f"  {what} {kind}: {r} rounds, wall {wall_us / 1e3:.1f} ms "
                f"({wall_us / 1e3 / max(r, 1):.3f} ms/round), device busy "
                f"{busy / 1e3:.1f} ms, idle share "
                f"{1 - busy / wall_us:.3f}, {count / max(r, 1):.1f} "
                f"kernels/round")
            for e in sorted(kern, key=_self_device_us, reverse=True)[:6]:
                t = _self_device_us(e)
                log(f"      {t / max(busy, 1):6.1%}  {e.count:7d}x  "
                    f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# phases 5 and 6: xDeepFM scoring and the attention entry point
# ---------------------------------------------------------------------------

def counted(torch, fn):
    """``fn()`` once with every launch count set to 0 just before and read
    just after: (its result, the counts)."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _build.launch_counts()


def forward_stages(torch, model, idx, reps, spans):
    """A forward's stages on the same batch: the median event times of the
    embedding bag and of each CIN layer (the rest of the forward is the
    linear term, the DNN and the output products), and each CIN layer's
    output, on the forward's own x_0 and x_k, held against the plain
    version in float64 on the rows of ``spans`` ([lo, hi) pairs).

    The CIN check is relative to the layer's largest exact output (at
    most 3e-4, the reference's CIN tolerance): at the init scales a
    layer-2 or layer-3 output moves a logit by far less than the logits'
    tolerances, so those checks cannot see these layers.  Returns the
    times and each layer's relative error."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.xdeepfm import embedding_bag
    p = model.params()
    parts = {"embedding_bag": time_ms(
        torch, lambda: embedding_bag(p["table"], idx), reps=reps, warmup=1)}
    x0 = embedding_bag(p["table"], idx)
    xk = x0
    rel = []
    for i, w in enumerate(p["cin"]):
        parts[f"cin_layer {i + 1} (H={xk.shape[1]})"] = time_ms(
            torch, lambda: ops.cin_layer(xk, x0, w), reps=reps, warmup=1)
        out = ops.cin_layer(xk, x0, w)
        worst = 0.0
        for lo, hi in spans:
            exact = ref.cin_layer_ref(xk[lo:hi].double(), x0[lo:hi].double(),
                                      w.double())
            worst = max(worst, float((out[lo:hi].double() - exact).abs().max()
                                     / exact.abs().max()))
            del exact
        check(worst <= 3e-4, f"cin_layer {i + 1} of the forward: relative "
                             f"error {worst:.3e} against float64 > 3e-4")
        rel.append(worst)
        xk = out
    return parts, rel


def xdeepfm_phase(torch):
    """The paper's FULL xDeepFM on the card: serve_p99, serve_bulk and
    retrieval_cand through ``XDeepFM``, each forward counted (3 CIN
    launches), timed by CUDA events and checked.  Returns the summed
    launch counts of the counted runs."""
    from repro_torch.configs import xdeepfm as xcfg
    from repro_torch.data.synthetic import RecsysStream
    from repro_torch.models.xdeepfm import XDeepFM
    cfg = xcfg.FULL
    dev = torch.device(DEVICE)
    launches = {}

    def run(fn, what, forwards=1):
        out, lc = counted(torch, fn)
        check(lc["cin_layer"] == 3 * forwards,
              f"xdeepfm {what}: {lc['cin_layer']} cin_layer launches, "
              f"want {3 * forwards}")
        check(bool(torch.isfinite(out).all()), f"xdeepfm {what}: "
                                               "non-finite output")
        for key, val in lc.items():
            launches[key] = launches.get(key, 0) + val
        return out

    def batch(B, seed=0):
        s = RecsysStream(cfg.sizes(), cfg.offsets, batch=B,
                         values=xcfg.VALUES_PER_FIELD, seed=seed)
        return torch.from_numpy(s.next_batch()["indices"]).to(dev)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = XDeepFM.init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    log(f"[xdeepfm] FULL: {cfg.n_fields} fields, embed {cfg.embed_dim}, "
        f"CIN {cfg.cin_layers}, MLP {cfg.mlp_dims}, {cfg.total_rows:,} "
        f"table rows, {n_par:,} parameters ({n_par * 4 / 2 ** 30:.3f} GiB)"
        f", init {time.perf_counter() - t0:.2f} s")
    out = {}
    for shape in ("serve_p99", "serve_bulk"):
        B = xcfg.SHAPES[shape]["batch"]
        t0 = time.perf_counter()
        idx = batch(B)
        t_data = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        logits = run(lambda: model(idx), shape)
        check(logits.shape == (B,), f"xdeepfm {shape}: logits "
                                    f"{tuple(logits.shape)}")
        reps = 25 if B <= 4096 else 5
        ms = time_ms(torch, lambda: model(idx), reps=reps, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        flops = xcfg.cell_flops(cfg, B)
        log(f"  {shape} B={B}: {ms:.4f} ms a forward (median of {reps}, "
            f"events), {B / ms * 1e3:,.0f} rows/s, "
            f"{flops / ms / 1e9:.2f} TFLOP/s of model FLOPs, peak "
            f"{peak:.3f} GiB, batch drawn in {t_data:.2f} s (host)")
        spans = [(0, B)] if B <= 4096 else [(0, 4096), (B - 4096, B)]
        parts, rel = forward_stages(torch, model, idx,
                                    min(reps, 3 + reps // 5), spans)
        log("    stages (events): " + ", ".join(
            f"{k} {v:.4f} ms ({v / ms:.1%})" for k, v in parts.items())
            + f"; the rest {ms - sum(parts.values()):.4f} ms")
        log("    CIN layers vs float64 on rows " + ", ".join(
            f"{lo}..{hi - 1}" for lo, hi in spans) + ": max |err| / max "
            "|exact| " + ", ".join(f"{e:.3e}" for e in rel) + " (<= 3e-4)")
        out[shape] = dict(idx=idx, logits=logits, ms=ms, peak_gib=peak)

    # rows are independent: the bulk forward's first rows equal a forward
    # of those rows alone
    head = out["serve_bulk"]["idx"][:4096].contiguous()
    small = run(lambda: model(head), "serve_bulk head")
    err = max_abs_err(torch, out["serve_bulk"]["logits"][:4096], small)
    log(f"  serve_bulk rows 0..4095 vs a B=4096 forward: max_abs_err "
        f"{err:.3e} (rtol = atol = 1e-4)")
    check(torch.allclose(out["serve_bulk"]["logits"][:4096], small,
                         rtol=1e-4, atol=1e-4),
          "xdeepfm: bulk rows differ from a forward of the same rows")
    del out["serve_bulk"]
    torch.cuda.empty_cache()

    # retrieval_cand: one query against 10^6 candidate embeddings
    n_cand = xcfg.SHAPES["retrieval_cand"]["n_cand"]
    query = batch(1)
    cand = torch.randn((n_cand, cfg.embed_dim), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    scores, _ = counted(torch, lambda: model.retrieval_scores(query, cand))
    check(scores.shape == (n_cand,) and bool(torch.isfinite(scores).all()),
          "xdeepfm retrieval: bad scores")
    qv = model.table[query[0].clamp(min=0).long()]
    qv = (qv * (query[0] >= 0)[..., None]).sum(1).double().mean(0)
    want = cand.double() @ qv
    check(torch.allclose(scores.double(), want, rtol=1e-4, atol=1e-7),
          "xdeepfm retrieval: scores differ from a float64 product")
    ms = time_ms(torch, lambda: model.retrieval_scores(query, cand))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  retrieval_cand 1 x {n_cand:,}: {ms:.4f} ms (median of {REPS}, "
        f"events), peak {peak:.3f} GiB, vs float64 product max_abs_err "
        f"{max_abs_err(torch, scores.double(), want):.3e}")

    # the card's serve_p99 logits against the port's CPU forward with the
    # same weights and batch (the plain versions)
    p99 = out["serve_p99"]
    model.to("cpu")
    cpu = model(p99["idx"].cpu())
    err = max_abs_err(torch, p99["logits"].cpu(), cpu)
    log(f"  serve_p99 card vs CPU forward: max_abs_err {err:.3e} "
        f"(rtol = atol = 1e-4)")
    check(torch.allclose(p99["logits"].cpu(), cpu, rtol=1e-4, atol=1e-4),
          "xdeepfm: the card's serve_p99 logits differ from the CPU's")
    del model
    torch.cuda.empty_cache()
    return launches


def attention_entry_phase(torch):
    """One ``ops.flash_attention`` call at a qwen3-32b layer's shape in
    bf16, K/V repeated from 8 heads; its launch counts."""
    from repro_torch.kernels import ops, ref
    q, k, v = attn_inputs(torch, torch.bfloat16, seed=1)
    o, lc = counted(torch, lambda: ops.flash_attention(q, k, v,
                                                       causal=True))
    check(lc["flash_attention"] == 1, "ops.flash_attention launched "
                                      f"{lc['flash_attention']} kernels")
    check(o.shape == q.shape and o.dtype == q.dtype
          and bool(torch.isfinite(o).all()), "flash_attention: bad output")
    want = ref.flash_attention_ref(q, k, v, causal=True)
    err = max_abs_err(torch, o.float(), want.float())
    tol = ATTN_TOL["bfloat16"]
    log(f"  ops.flash_attention bf16 {tuple(q.shape)} causal: launches "
        f"{lc['flash_attention']}, vs plain max_abs_err {err:.3e} "
        f"(rtol {tol['rtol']:g}, atol {tol['atol']:g})")
    check(torch.allclose(o.float(), want.float(), **tol),
          "ops.flash_attention disagrees with the plain version")
    return lc


# ---------------------------------------------------------------------------
# phase 8: LM serving
# ---------------------------------------------------------------------------

LM_LAYERS = 4                 # [lm] qwen3-32b at full width, 4 of 64 layers
LM_SHAPE = dict(B=8, S=1024, new=32)
MOE_LAYERS = 2                # [lm] deepseek-moe-16b at full width, 2 of 28
MOE_SHAPE = dict(B=4, S=256, new=8)
LM_SMOKE_ARCHS = ("qwen3-32b", "deepseek-moe-16b",
                  "llama4-maverick-400b-a17b")
SMOKE_PROMPTS = (40, 33, 17, 9)   # ragged, left-padded into one group
SMOKE_NEW = 16
# the batched bf16 prefill against S decode steps of the same prompt: the
# two orders round the residual stream's bf16 values differently at every
# layer.  The logits have std ~1 and |max| ~4-5, where one bf16 step is
# 0.0156; a CPU run at reduced widths (4 layers, d 512) gave a max error
# of 0.039 and a mean of 0.006, qwen3-32b's [lm] run on the H100 0.0625
# and 0.0098.  Allowed: |a - b| <= 0.15 + 0.02 |b| and a mean of 0.025;
# a wrong position, mask or cache slot moves logits by ~1
PREFILL_TOL = dict(rtol=2e-2, atol=1.5e-1)
PREFILL_MEAN_TOL = 2.5e-2
# MoE routing flips between the two paths (prefill_vs_steps) allowed on
# at most this share of a layer's tokens (a token's first flip; up to
# 3.5% of a layer's 1,024 tokens in deepseek-moe-16b's [lm] run on the
# H100, 2.9% at reduced widths on the CPU)
FLIP_SHARE = 0.1


def lm_work(cfg, B: int, S: int):
    """The least bytes and operations of a bf16 prefill of ``B`` prompts
    of ``S`` tokens and of one decode step at position S: each weight
    read once (the embedding table only gathered; of a MoE layer's
    experts, all in the prefill and at most B * top_k in a step), the
    cache written once and read once a step, and 2 operations a
    multiply-add: the products of the tokens' active weights, the causal
    attention, the head at the last position only.  Returns ((bytes,
    ops) of the prefill, (bytes, ops) of a step)."""
    d, hd, H, Hkv, L = (cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads,
                        cfg.n_layers)
    elt = 2
    attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
    act, weights, weights_step = 0, 0, 0
    for i in range(L):
        if cfg.layer_is_moe(i):
            E, f, K = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.moe.top_k
            shared = 3 * d * f * cfg.moe.n_shared
            act += attn + d * E + 3 * d * f * K + shared
            weights += attn + d * E + 3 * d * f * E + shared
            weights_step += attn + d * E + 3 * d * f * min(E, B * K) + shared
        else:
            act += attn + 3 * d * cfg.d_ff
            weights += attn + 3 * d * cfg.d_ff
            weights_step += attn + 3 * d * cfg.d_ff
    head = d * cfg.vocab
    kv = 2 * L * B * Hkv * hd * elt                # bytes a position
    pre_ops = (2.0 * B * S * act + 2.0 * B * H * S * S * hd * L
               + 2.0 * B * head)
    pre_bytes = (elt * (weights + head + B * S * d) + kv * S
                 + 4 * B * cfg.vocab)
    step_ops = 2.0 * B * (act + head) + 4.0 * B * H * (S + 1) * hd * L
    step_bytes = (elt * (weights_step + head + B * d) + kv * (S + 1)
                  + 4 * B * cfg.vocab)
    return (pre_bytes, pre_ops), (step_bytes, step_ops)


def watch_plain_attention():
    """Wraps ``ref.flash_attention_ref`` (the plain version B6's wrapper
    takes for CPU tensors) to count its calls; returns the count list
    and the undo."""
    from repro_torch.kernels import ref
    real = ref.flash_attention_ref
    calls = []

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    ref.flash_attention_ref = counting

    def undo():
        ref.flash_attention_ref = real
    return calls, undo


def served(torch, server, reqs, what):
    """``server.generate(reqs)`` once, counted, with the plain attention
    watched: (host seconds, launch counts)."""
    calls, undo = watch_plain_attention()
    try:
        t0 = time.perf_counter()
        _, lc = counted(torch, lambda: server.generate(reqs))
        dt = time.perf_counter() - t0
    finally:
        undo()
    check(not calls, f"[lm] {what}: the plain attention ran {len(calls)} "
                     f"times on the card's path")
    return dt, lc


def watch_routing(torch):
    """Wraps ``transformer.moe_ffn`` to record, for each call, every
    token's top-k expert set (sorted) and the router's probability gap
    between its k-th and (k+1)-th choice; returns the record list and
    the undo."""
    from repro_torch.models import transformer as tfm
    real = tfm.moe_ffn
    calls = []

    def watching(params, x, cfg):
        probs = torch.softmax(x.float() @ params["router"], dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1)
        calls.append((top.indices[..., :cfg.top_k].sort(-1).values,
                      top.values[..., -2] - top.values[..., -1]))
        return real(params, x, cfg)
    tfm.moe_ffn = watching

    def undo():
        tfm.moe_ffn = real
    return calls, undo


def prefill_vs_steps(torch, params, cfg, toks, max_seq):
    """The batched bf16 prefill against S decode steps from an empty
    cache on the same prompts: the last logits and every cache slot
    within ``PREFILL_TOL`` (and the logits' mean error within
    ``PREFILL_MEAN_TOL``).

    A MoE router can order two experts differently on the two paths
    when their probabilities tie within bf16 rounding (a routing flip):
    that token's layer output then differs by O(1).  The router is
    watched on both paths; a flipped token's cache rows in the later
    layers and, if it is a prompt's last token, its logits row are
    excused, provided flips are rare (at most ``FLIP_SHARE`` of the
    tokens of any layer flip there first).  The largest probability gap
    between a flipped token's k-th and (k+1)-th expert is logged."""
    from repro_torch.models import transformer as tfm
    B, S = toks.shape
    calls, undo = watch_routing(torch)
    try:
        logits, cache = tfm.prefill(params, toks, cfg, max_seq)
        batched = list(calls)
        calls.clear()
        t0 = time.perf_counter()
        steps = tfm.init_cache(cfg, B, max_seq, device=toks.device)
        for t in range(S):
            step_logits, steps = tfm.decode_step(params, steps, toks[:, t],
                                                 cfg)
        torch.cuda.synchronize()
        t_steps = time.perf_counter() - t0
    finally:
        undo()
    moe_layers = [i for i in range(cfg.n_layers) if cfg.layer_is_moe(i)]
    flipped = torch.zeros((B, S), dtype=torch.bool, device=toks.device)
    excused, n_flips, worst_gap, worst_share = [], 0, 0.0, 0.0
    for i in range(cfg.n_layers):
        excused.append(flipped.clone())     # rows of layer i's cache
        if i in moe_layers:
            j = moe_layers.index(i)
            sets = torch.cat([calls[t * len(moe_layers) + j][0]
                              for t in range(S)], dim=1)
            gaps = torch.cat([calls[t * len(moe_layers) + j][1]
                              for t in range(S)], dim=1)
            # a token already flipped in an earlier layer has another
            # input here: only its first flip counts
            flip = (batched[j][0] != sets).any(-1) & ~flipped
            n_flips += int(flip.sum())
            worst_share = max(worst_share, float(flip.float().mean()))
            if flip.any():
                worst_gap = max(worst_gap, float(torch.maximum(
                    batched[j][1], gaps)[flip].max()))
            flipped |= flip
    rows_ok = ~flipped[:, -1]
    diff = (logits - step_logits).abs()[rows_ok]
    bad_rows = 0
    ok = bool(torch.allclose(logits[rows_ok], step_logits[rows_ok],
                             **PREFILL_TOL))
    ok &= diff.numel() == 0 or float(diff.mean()) <= PREFILL_MEAN_TOL
    cache_err = 0.0
    for i in range(cfg.n_layers):
        keep = ~excused[i]
        for a, b in ((cache.k[i], steps.k[i]), (cache.v[i], steps.v[i])):
            a, b = a[:, :S][keep].float(), b[:, :S][keep].float()
            cache_err = max(cache_err, float((a - b).abs().max()))
            close = torch.isclose(a, b, **PREFILL_TOL).flatten(1).all(1)
            bad_rows += int((~close).sum())
    ok &= bad_rows == 0 and worst_share <= FLIP_SHARE
    same_top = float((logits.argmax(-1) == step_logits.argmax(-1))
                     .float().mean())
    log(f"    batched prefill vs {S} decode steps ({t_steps:.2f} s): "
        f"logits max |err| {float(diff.max()) if diff.numel() else 0:.4f},"
        f" mean {float(diff.mean()) if diff.numel() else 0:.5f} (|max "
        f"logit| {float(step_logits.abs().max()):.3f}; {int(rows_ok.sum())}"
        f" of {B} rows held), cache max |err| {cache_err:.4f}, same argmax "
        f"{same_top:.3f}; first routing flips {n_flips} (largest share "
        f"of a layer's tokens {worst_share:.4f}, largest gap "
        f"{worst_gap:.2e}; "
        f"rtol {PREFILL_TOL['rtol']:g}, atol {PREFILL_TOL['atol']:g}, mean "
        f"{PREFILL_MEAN_TOL:g}, share {FLIP_SHARE:g}: "
        f"{'ok' if ok else 'FAILED'})")
    check(ok, f"[lm] {cfg.name}: the batched prefill differs from the "
              f"decode steps")


def lm_full_width(torch, cfg, shape, rec):
    """One full-width bf16 config on the card: random weights (seed 0),
    ``BatchServer`` over B prompts of S tokens (numpy seed 0), greedy,
    served twice (the first request and a warm one, the same tokens),
    each counted (one B6 launch a layer, the plain attention never
    called); then prefill and decode-step times against their bounds, B6
    on the prefill's own layer-0 q/k/v against its plain version (the
    kernel phase times it at that shape, ``LM_ATTN_SHAPE``), and the
    batched prefill against S decode steps of the same prompts
    (``prefill_vs_steps``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.models import attention, transformer as tfm
    from repro_torch.models.common import rope_frequencies
    from repro_torch.runtime.serve_loop import BatchServer, Request
    dev = torch.device(DEVICE)
    B, S, new = shape["B"], shape["S"], shape["new"]
    max_seq = S + new + 8
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    torch.cuda.synchronize()
    n_par = cfg.param_count()
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.hd}, vocab {cfg.vocab:,}, "
        f"{n_par / 1e9:.3f} B parameters ({n_par * 2 / 2 ** 30:.2f} GiB "
        f"bf16), init {time.perf_counter() - t0:.2f} s")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    toks = torch.from_numpy(prompts.astype(np.int32)).to(dev)
    server = BatchServer(params, cfg, batch=B, max_seq=max_seq, device=dev)
    torch.cuda.reset_peak_memory_stats()
    times, outs, launches = [], [], {}
    for _ in range(2):            # the first request, then a warm one
        reqs = [Request(prompt=p.tolist(), max_new=new) for p in prompts]
        dt, lc = served(torch, server, reqs, cfg.name)
        check(lc["flash_attention"] == cfg.n_layers,
              f"[lm] {cfg.name}: {lc['flash_attention']} B6 launches in "
              f"one prefill, want {cfg.n_layers}")
        check(all(len(r.out) == new
                  and all(0 <= t < cfg.vocab for t in r.out) for r in reqs),
              f"[lm] {cfg.name}: bad tokens")
        times.append(dt)
        outs.append([r.out for r in reqs])
        for key, val in lc.items():
            launches[key] = launches.get(key, 0) + val
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(outs[0] == outs[1], f"[lm] {cfg.name}: greedy tokens differ "
                              f"between two requests")

    with torch.inference_mode():
        logits, cache = tfm.prefill(params, toks, cfg, max_seq)
        check(logits.shape == (B, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"[lm] {cfg.name}: bad prefill logits")
        pre_ms = time_ms(torch, lambda: tfm.prefill(params, toks, cfg,
                                                    max_seq),
                         reps=5, warmup=1)
        tok = logits.argmax(-1).to(torch.int32)
        step_ms = time_ms(torch, lambda: tfm.decode_step(params, cache, tok,
                                                         cfg),
                          reps=20, warmup=3)
        (pb, po), (sb, so) = lm_work(cfg, B, S)
        pre_bound, pre_by = bound(pb, po, BF16_OPS_PER_S)
        step_bound, step_by = bound(sb, so, BF16_OPS_PER_S)
        log(f"  {cfg.name} B={B} S={S} +{new} greedy, served twice (host "
            f"clock, one prefill + {new} steps each): first {times[0]:.3f}"
            f" s, then {times[1]:.3f} s = {B * new / times[1]:,.1f} "
            f"tokens/s, the same tokens; peak {peak:.2f} GiB; B6 launches "
            f"{lc['flash_attention']} a request (one a layer), plain "
            f"attention 0")
        log(f"    prefill {pre_ms:.3f} ms (median of 5, events), bound "
            f"{pre_bound:.3f} ms ({pre_by}: {po / 1e12:.2f} TFLOP dense "
            f"bf16, {pb / 1e9:.2f} GB), {po / pre_ms / 1e9:.1f} TFLOP/s; "
            f"decode {step_ms:.3f} ms a token-step (median of 20, events), "
            f"bound {step_bound:.3f} ms ({step_by}: {sb / 1e9:.2f} GB), "
            f"{B / step_ms * 1e3:,.1f} tokens/s in steady decode")

        # B6 on the prefill's own layer-0 q/k/v
        x = params["embed"][toks]
        rope = rope_frequencies(cfg.hd, S, cfg.rope_theta, device=dev)
        q, k, v = tfm.attention_qkv(params["layers"][0], x, cfg, rope)
        qh, kh, vh = attention.gqa_heads(q, k, v)
        got = flash_attention(qh, kh, vh, causal=True)
        want = ref.flash_attention_ref(qh, kh, vh, causal=True)
        err = max_abs_err(torch, got.float(), want.float())
        tol = ATTN_TOL["bfloat16"]
        ok = torch.allclose(got.float(), want.float(), **tol)
        what = (f"bf16 B={B} H={cfg.n_heads} S={S} d={cfg.hd} causal, "
                f"{cfg.name} layer 0")
        log(f"    flash_attention {what}: max_abs_err {err:.3e} (rtol "
            f"{tol['rtol']:g}, atol {tol['atol']:g}: "
            f"{'ok' if ok else 'FAILED'})")
        check(ok, f"flash_attention disagrees with its plain version "
                  f"({what})")
        r = rec["flash_attention"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        del got, want, x, q, k, v, qh, kh, vh

    prefill_vs_steps(torch, params, cfg, toks, max_seq)
    del params, cache, server
    torch.cuda.empty_cache()
    return launches


def lm_smoke_parity(torch):
    """The smoke configs in f32, card against the port's CPU run: the
    same weights and ragged prompts through ``BatchServer`` (one group),
    greedy tokens equal and the prefill's logits within the f32
    attention tolerance.  Returns the card runs' launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import BatchServer, Request
    dev = torch.device(DEVICE)
    runs = []
    for arch in LM_SMOKE_ARCHS:
        cfg = get_arch(arch).smoke
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        card = _tree_to(params, dev)

        def reqs():
            rng = np.random.default_rng(1)
            return [Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                            max_new=SMOKE_NEW) for n in SMOKE_PROMPTS]
        max_seq = max(SMOKE_PROMPTS) + SMOKE_NEW + 8
        cpu = BatchServer(params, cfg, batch=len(SMOKE_PROMPTS),
                          max_seq=max_seq, device="cpu").generate(reqs())
        got = reqs()
        _, lc = served(torch, BatchServer(card, cfg, batch=len(got),
                                          max_seq=max_seq, device=dev),
                       got, arch + " smoke")
        check(lc["flash_attention"] == cfg.n_layers,
              f"[lm] {arch} smoke: {lc['flash_attention']} B6 launches")
        runs.append(lc)
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab, (4, max(SMOKE_PROMPTS))).astype(np.int32))
        with torch.inference_mode():
            want, _ = tfm.prefill(params, toks, cfg, max_seq)
            lg, _ = tfm.prefill(card, toks.to(dev), cfg, max_seq)
        err = max_abs_err(torch, lg.cpu(), want)
        tol = ATTN_TOL["float32"]
        same = [r.out for r in got] == [r.out for r in cpu]
        ok = torch.allclose(lg.cpu(), want, **tol)
        log(f"  {arch} smoke f32: {len(got)} prompts of {SMOKE_PROMPTS} "
            f"tokens, +{SMOKE_NEW} greedy: card tokens "
            f"{'==' if same else '!='} CPU tokens; prefill logits card vs "
            f"CPU max_abs_err {err:.3e} (rtol {tol['rtol']:g}, atol "
            f"{tol['atol']:g}: {'ok' if ok else 'FAILED'}); B6 launches "
            f"{lc['flash_attention']}")
        check(same, f"[lm] {arch} smoke: the card's greedy tokens differ "
                    f"from the CPU's")
        check(ok, f"[lm] {arch} smoke: the card's prefill logits differ "
                  f"from the CPU's")
    return runs


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def lm_phase(torch, rec):
    """LM serving on the card: qwen3-32b at full width cut to
    ``LM_LAYERS`` layers and deepseek-moe-16b at full width cut to
    ``MOE_LAYERS`` (``lm_full_width``), the three smoke configs in f32
    against the CPU (``lm_smoke_parity``), and the ``serve`` launcher's
    ``main`` on the card.  Returns the counted runs' launch counts."""
    import contextlib
    import dataclasses
    import io
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    runs = []
    qwen = dataclasses.replace(get_arch("qwen3-32b").full,
                               n_layers=LM_LAYERS)
    runs.append(lm_full_width(torch, qwen, LM_SHAPE, rec))
    moe = dataclasses.replace(get_arch("deepseek-moe-16b").full,
                              n_layers=MOE_LAYERS)
    runs.append(lm_full_width(torch, moe, MOE_SHAPE, rec))
    runs += lm_smoke_parity(torch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, lc = counted(torch, lambda: serve.main(
            ["--arch", "qwen3-32b", "--device", DEVICE]))
    text = out.getvalue()
    log(f"  serve --arch qwen3-32b --device {DEVICE} (smoke): "
        + " | ".join(text.strip().splitlines()[:1])
        + f"; B6 launches {lc['flash_attention']}")
    check(rc == 0 and f"on {DEVICE}" in text and lc["flash_attention"] ==
          get_arch("qwen3-32b").smoke.n_layers,
          f"[lm] the serve launcher failed on the card: rc {rc}, {text!r}")
    runs.append(lc)
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4              # [train] qwen3-32b at full width, 4 of 64
TRAIN_SHAPE = dict(B=4, S=1024, steps=5)
TRAIN_MOE_LAYERS = 2          # [train] deepseek-moe-16b at full width, 2 of 28
TRAIN_MOE_SHAPE = dict(B=4, S=512, steps=3)
XDEEPFM_TRAIN_STEPS = 3
SMOKE_SGD = dict(steps=60, lr=0.1, batch=64)
LM_TRAIN_ARCHS = ("command-r-35b", "command-r-plus-104b", "deepseek-moe-16b",
                  "llama4-maverick-400b-a17b", "qwen3-32b")


def counting_steps(torch, trainer):
    """Wraps ``trainer.step_fn`` so that every step runs with the launch
    counts set to 0 just before and read just after; returns the list
    the counts of each step go to."""
    from repro_torch.kernels import _build
    real = trainer.step_fn
    per_step = []

    def step(*a):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = real(*a)
        torch.cuda.synchronize()
        per_step.append(_build.launch_counts())
        return out
    trainer.step_fn = step
    return per_step


def train_work(cfg, B: int, S: int):
    """(operations, AdamW bytes) of one training step of an LM on B
    sequences of S tokens: 6 operations a token for every weight of a
    product the token goes through (the embedding is a gather, not a
    product; of a MoE layer's experts the top-k and the shared), plus
    the causal attention (forward 2 and backward 5 products of S*S*hd
    multiply-adds, half masked, a head and layer); AdamW reads params,
    grads and both f32 moments and writes params and moments once."""
    emb = cfg.vocab * cfg.d_model
    ops = (6.0 * (cfg.active_param_count() - emb) * B * S
           + 7.0 * B * cfg.n_heads * S * S * cfg.hd * cfg.n_layers)
    elt = 2 if cfg.param_dtype == "bfloat16" else 4
    return ops, cfg.param_count() * (3 * elt + 16)


def lm_train_full(torch, cfg, shape):
    """``Trainer`` on one full-width bf16 config: random weights (seed 0),
    ``shape["steps"]`` AdamW steps on ``TokenStream(vocab, S, B)``, each
    counted (one B6 forward with lse and one B6 backward a layer, no
    plain attention); loss and grad norm finite and the norm above 0, a
    MoE router moved; step ms, tokens/s and peak GiB against
    ``train_work``'s bound.  Returns the steps' launch counts."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    dev = torch.device(DEVICE)
    B, S, steps = shape["B"], shape["S"], shape["steps"]
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    torch.cuda.synchronize()
    n_par = cfg.param_count()
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab:,}, "
        f"{n_par / 1e9:.3f} B parameters, init "
        f"{time.perf_counter() - t0:.2f} s")
    moe = [i for i in range(cfg.n_layers) if cfg.layer_is_moe(i)]
    router0 = (params["layers"][moe[0]]["moe"]["router"].clone()
               if moe else None)
    torch.cuda.reset_peak_memory_stats()
    stream = TokenStream(cfg.vocab, S, B, seed=0)
    trainer = Trainer(lambda p, b: tfm.loss_fn(p, b, cfg), params,
                      TrainConfig(peak_lr=1e-4, warmup=2, total_steps=steps),
                      stream.next_batch, name=cfg.name)
    per_step = counting_steps(torch, trainer)
    calls, undo = watch_plain_attention()
    try:
        hist = trainer.run(steps, log_every=1,
                           print_fn=lambda line: log("    " + line))
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(not calls, f"[train] {cfg.name}: the plain attention ran")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              and h["grad_norm"] > 0 for h in hist),
          f"[train] {cfg.name}: non-finite loss or zero grad norm: {hist}")
    L = cfg.n_layers
    for lc in per_step:
        check(lc["flash_attention_lse"] == L and lc["flash_attention_bwd"]
              == L and lc["flash_attention"] == 0,
              f"[train] {cfg.name}: launches a step {nonzero(lc)}, want "
              f"{L} B6 forwards with lse and {L} B6 backwards")
    if moe:
        moved = float((trainer.params["layers"][moe[0]]["moe"]["router"]
                       .detach() - router0).abs().max())
        check(np.isfinite(moved) and moved > 0,
              f"[train] {cfg.name}: the router did not move ({moved})")
        log(f"    MoE router of layer {moe[0]}: max |change| {moved:.3e} "
            f"after {steps} steps")
    times = [h["step_time_s"] for h in hist]
    warm = statistics.median(times[1:])
    ops, adam_bytes = train_work(cfg, B, S)
    b_ops = ops / BF16_OPS_PER_S * 1e3
    b_adam = adam_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  {cfg.name} B={B} S={S}: {steps} AdamW steps, loss "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, grad norm "
        f"{hist[-1]['grad_norm']:.3f}; step {times[0] * 1e3:.1f} ms first, "
        f"{warm * 1e3:.1f} ms median of the rest (host clock) = "
        f"{B * S / warm:,.0f} tokens/s; bound {b_ops + b_adam:.1f} ms "
        f"({ops / 1e12:.2f} TFLOP at the dense bf16 peak {b_ops:.1f} ms + "
        f"AdamW {adam_bytes / 1e9:.1f} GB at 3.35 TB/s {b_adam:.1f} ms), "
        f"{ops / warm / 1e12:.1f} TFLOP/s; peak {peak:.2f} GiB; launches a "
        f"step {nonzero(per_step[-1])}")
    del trainer, params, router0
    torch.cuda.empty_cache()
    return per_step


def xdeepfm_train_full(torch):
    """``Trainer`` on the FULL xDeepFM (uncut table) at the reference's
    ``train_batch`` width: AdamW steps with the CIN launches of every
    step pinned to the count the code implies (one forward a layer, and
    ``cin.backward_launches`` a layer); loss finite, rows/s.  Returns the
    steps' launch counts."""
    from repro_torch.configs import xdeepfm as xcfg
    from repro_torch.data.synthetic import RecsysStream
    from repro_torch.kernels import cin
    from repro_torch.models import xdeepfm as xd
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    cfg = xcfg.FULL
    dev = torch.device(DEVICE)
    B = xcfg.SHAPES["train_batch"]["batch"]
    params = xd.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    stream = RecsysStream(cfg.sizes(), cfg.offsets, B,
                          values=xcfg.VALUES_PER_FIELD, seed=0)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(xd.loss_fn, params, TrainConfig(
        peak_lr=1e-3, warmup=1, total_steps=XDEEPFM_TRAIN_STEPS),
        stream.next_batch, name="xdeepfm")
    per_step = counting_steps(torch, trainer)
    hist = trainer.run(XDEEPFM_TRAIN_STEPS, log_every=1,
                       print_fn=lambda line: log("    " + line))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"cin_layer": len(cfg.cin_layers), "cin_weight_grad": 0}
    h_prev = cfg.n_fields
    for h in cfg.cin_layers:
        for key, n in cin.backward_launches(h_prev, cfg.n_fields).items():
            want[key] += n
        h_prev = h
    for lc in per_step:
        check({k: lc[k] for k in want} == want,
              f"[train] xdeepfm: CIN launches a step {nonzero(lc)}, want "
              f"{want}")
    check(all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist),
          f"[train] xdeepfm: bad loss or grad norm {hist}")
    times = [h["step_time_s"] for h in hist]
    warm = statistics.median(times[1:])
    log(f"  xdeepfm FULL ({cfg.total_rows:,} table rows) B={B}: "
        f"{XDEEPFM_TRAIN_STEPS} AdamW steps, loss {hist[0]['loss']:.4f} -> "
        f"{hist[-1]['loss']:.4f}; step {times[0] * 1e3:.1f} ms first, "
        f"{warm * 1e3:.1f} ms median of the rest (host clock) = "
        f"{B / warm:,.0f} rows/s; model FLOPs of a step (3 x forward) "
        f"{3 * xcfg.cell_flops(cfg, B) / 1e12:.2f} TFLOP; peak {peak:.2f} GiB;"
        f" CIN launches a step {want}")
    del trainer, params
    torch.cuda.empty_cache()
    return per_step


def xdeepfm_smoke_sgd(torch):
    """The reference's ``test_training_reduces_loss`` on the card: SMOKE
    xDeepFM, 60 plain SGD steps at lr 0.1 on batches of 64; the mean loss
    of the last 5 steps must be 0.03 below the first 5's.  Returns the
    run's launch counts."""
    from repro_torch.checkpoint.store import tree_leaves
    from repro_torch.configs import xdeepfm as xcfg
    from repro_torch.data.synthetic import RecsysStream
    from repro_torch.models import xdeepfm as xd
    cfg = xcfg.SMOKE
    dev = torch.device(DEVICE)
    params = xd.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, requires_grad=True)
    leaves = tree_leaves(params)
    stream = RecsysStream(cfg.sizes(), cfg.offsets, batch=SMOKE_SGD["batch"],
                          seed=0)

    def run():
        losses = []
        for _ in range(SMOKE_SGD["steps"]):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in stream.next_batch().items()}
            loss, _ = xd.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for p, gr in zip(leaves, grads):
                    p -= SMOKE_SGD["lr"] * gr
            losses.append(loss.detach())
        return [float(x) for x in losses]
    losses, lc = counted(torch, run)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"  xdeepfm SMOKE, {SMOKE_SGD['steps']} SGD steps at lr "
        f"{SMOKE_SGD['lr']}: mean loss of the first 5 {first:.4f}, of the "
        f"last 5 {last:.4f} (must fall by 0.03); launches {nonzero(lc)}")
    check(last < first - 0.03, "[train] xdeepfm SMOKE: the loss did not "
                               "fall")
    check(lc["cin_weight_grad"] == SMOKE_SGD["steps"] * len(cfg.cin_layers),
          f"[train] xdeepfm SMOKE: launches {nonzero(lc)}")
    return lc


def lm_train_smoke_parity(torch):
    """The five LM smoke configs in f32, card against the port's CPU run:
    the same weights and ``TokenStream`` batch through ``loss_fn``, loss
    and every gradient leaf within the f32 attention tolerance (2e-3, of
    the leaf's largest gradient for the absolute part).  Returns the card
    runs' launch counts."""
    from repro_torch.checkpoint.store import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as tfm
    dev = torch.device(DEVICE)
    tol = ATTN_TOL["float32"]["rtol"]
    runs = []
    for arch in LM_TRAIN_ARCHS:
        cfg = get_arch(arch).smoke
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        card = _tree_to(params, dev)
        toks = torch.from_numpy(TokenStream(cfg.vocab, 40, 3, seed=1)
                                .next_batch()["tokens"])

        def loss_grads(tree, tokens):
            leaves = tree_leaves(tree)
            for t in leaves:
                t.requires_grad_(True)
            loss, _ = tfm.loss_fn(tree, {"tokens": tokens}, cfg)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        want_loss, want = loss_grads(params, toks)
        (got_loss, got), lc = counted(torch, lambda: loss_grads(
            card, toks.to(dev)))
        check(lc["flash_attention_lse"] == lc["flash_attention_bwd"] ==
              cfg.n_layers, f"[train] {arch} smoke: launches {nonzero(lc)}")
        worst = 0.0
        ok = bool(torch.allclose(got_loss.cpu(), want_loss, rtol=tol,
                                 atol=tol))
        for a, b in zip(got, want, strict=True):
            scale = float(b.abs().max())
            worst = max(worst, float((a.cpu() - b).abs().max())
                        / max(scale, 1e-30))
            ok &= bool(torch.allclose(a.cpu(), b, rtol=tol,
                                      atol=tol * scale))
        log(f"  {arch} smoke f32: loss card {float(got_loss):.6f} vs CPU "
            f"{float(want_loss):.6f}; {len(got)} gradient leaves, worst "
            f"max |err| / max |grad| {worst:.3e} (rtol {tol:g}, atol {tol:g}"
            f" x max: {'ok' if ok else 'FAILED'}); B6 launches "
            f"{lc['flash_attention_lse']} forward, "
            f"{lc['flash_attention_bwd']} backward")
        check(ok, f"[train] {arch} smoke: the card's loss or gradients "
                  f"differ from the CPU's")
        runs.append(lc)
    return runs


def train_launcher(torch):
    """``launch/train.main`` on the card: qwen3-32b's smoke config, then
    xDeepFM's with checkpoints, and again with ``--resume auto`` from
    them.  Returns the runs' launch counts."""
    import contextlib
    import io
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.launch import train

    def main(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, lc = counted(torch, lambda: train.main(argv))
        return rc, lc, out.getvalue()
    runs = []
    steps = 10
    rc, lc, text = main(["--arch", "qwen3-32b", "--device", DEVICE,
                         "--steps", str(steps)])
    n = get_arch("qwen3-32b").smoke.n_layers
    log(f"  train --arch qwen3-32b --device {DEVICE} --steps {steps}: rc "
        f"{rc}, {text.strip().splitlines()[-1]!r}; launches {nonzero(lc)}")
    check(rc == 0 and f"done on {DEVICE}" in text
          and lc["flash_attention_bwd"] == steps * n,
          f"[train] the train launcher failed on the card: {text!r}")
    runs.append(lc)
    with tempfile.TemporaryDirectory() as ck:
        argv = ["--arch", "xdeepfm", "--device", DEVICE, "--steps", "4",
                "--batch", "64", "--ckpt-dir", ck, "--ckpt-every", "2"]
        for extra in ([], ["--resume", "auto"]):
            rc, lc, text = main(argv + extra)
            lines = text.strip().splitlines()
            log(f"  train --arch xdeepfm --ckpt-dir ... {' '.join(extra)}: "
                f"rc {rc}, {lines[0]!r} .. {lines[-1]!r}; launches "
                f"{nonzero(lc)}")
            check(rc == 0 and lc["cin_weight_grad"] == 4 * 2
                  and (not extra or "resumed from step 4" in text),
                  f"[train] the xdeepfm launcher run failed: {text!r}")
            runs.append(lc)
    return runs


def train_phase(torch):
    """Training on the card: qwen3-32b at full width cut to
    ``TRAIN_LAYERS`` layers and deepseek-moe-16b cut to
    ``TRAIN_MOE_LAYERS`` through ``Trainer`` (``lm_train_full``); the FULL
    xDeepFM at its training batch; the SMOKE xDeepFM's SGD run; the five
    LM smoke configs in f32 against the CPU; the ``train`` launcher.
    Returns the counted runs' launch counts."""
    import dataclasses
    from repro_torch.configs import get_arch
    runs = []
    qwen = dataclasses.replace(get_arch("qwen3-32b").full,
                               n_layers=TRAIN_LAYERS)
    runs += lm_train_full(torch, qwen, TRAIN_SHAPE)
    moe = dataclasses.replace(get_arch("deepseek-moe-16b").full,
                              n_layers=TRAIN_MOE_LAYERS)
    runs += lm_train_full(torch, moe, TRAIN_MOE_SHAPE)
    runs += xdeepfm_train_full(torch)
    runs.append(xdeepfm_smoke_sgd(torch))
    runs += lm_train_smoke_parity(torch)
    runs += train_launcher(torch)
    torch.cuda.empty_cache()
    return runs


KERNELS = {
    "frontier_relax": (
        "src/repro_torch/kernels/csrc/frontier_relax.cu",
        "src/repro/kernels/frontier_relax.py:117"),
    "frontier_scatter_min": (
        "src/repro_torch/kernels/csrc/frontier_relax.cu",
        "src/repro/kernels/frontier_relax.py:117"),
    "frontier_scatter_min_batch": (
        "src/repro_torch/kernels/csrc/frontier_relax.cu",
        "src/repro/kernels/frontier_relax.py:78"),
    "frontier_relax_csr": (
        "src/repro_torch/kernels/csrc/frontier_relax.cu",
        "src/repro/kernels/frontier_relax.py:78"),
    "relax_ell": ("src/repro_torch/kernels/csrc/relax.cu",
                  "src/repro/kernels/relax.py:44"),
    "masked_min": ("src/repro_torch/kernels/csrc/segment_min.cu",
                   "src/repro/kernels/segment_min.py:33"),
    "masked_min_pair": ("src/repro_torch/kernels/csrc/segment_min.cu",
                        "src/repro/kernels/segment_min.py:33"),
    "cin_layer": ("src/repro_torch/kernels/csrc/cin.cu",
                  "src/repro/kernels/cin.py:42"),
    # the backward of B5's weights: the reference's kernel has none
    "cin_weight_grad": ("src/repro_torch/kernels/csrc/cin.cu",
                        "src/repro/kernels/cin.py:42"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:72"),
    "flash_attention_lse": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                            "src/repro/kernels/flash_attn.py:72"),
    # B6's backward: the reference's kernel has none
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
                            "src/repro/kernels/flash_attn.py:72"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the first rounds of each route")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import sssp
    from repro_torch.core import generators
    from repro_torch.kernels import _build
    pt = {"sssp": sssp, "generators": generators}
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {card}")

    t_build = _build.build_all(verbose=True)
    log(f"[build] nvcc sm_90a, {len(_build.SOURCES)} sources in parallel: "
        f"{t_build:.1f} s")
    for fn in _build.SIGNATURES:
        _build.function(fn)

    log("[kernels] each SSSP kernel vs its plain version, tolerance 0")
    rec = kernel_phase(torch, pt)
    log("[kernels] cin_layer and flash_attention vs their plain versions")
    model_kernel_phase(torch, rec)
    log("[kernels] the backward kernels vs their plain versions")
    bwd_kernel_phase(torch, rec)
    # launch counts: set to 0 right before each main-path run and read
    # right after (solve_timed, counted)
    def phase(tag, what, fn):
        log(f"[{tag}] {what}")
        t0 = time.perf_counter()
        out = fn()
        log(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")
        return out
    runs = phase("main", "the SSSP main path, n = 2^20",
                 lambda: main_path(torch, pt))
    runs_dyn, dyn_keep = phase(
        "dynamic", "warm re-solves after a weight delta, n = 2^20",
        lambda: dynamic_phase(torch, pt))
    dist_ref = dyn_keep.pop("distributed")
    runs_p2p, p2p_keep = phase(
        "p2p", "landmark-seeded targeted queries, n = 2^20",
        lambda: p2p_phase(torch, pt, runs))
    runs_bidi = phase("bidi", "bidirectional point-to-point queries, n = "
                      "2^20", lambda: bidi_phase(torch, pt, p2p_keep,
                                                 dyn_keep))
    del p2p_keep, dyn_keep
    torch.cuda.empty_cache()
    runs_fleet = phase("fleet", "graph fleets and congestion replay",
                       lambda: fleet_phase(torch, pt))
    runs_serve = phase("serve", "the SSSP query service, n = 2^20",
                       lambda: serve_phase(torch, pt))
    runs_launch = phase("launch", "the serve_sssp launcher, grid n = 2^14",
                        lambda: launcher_phase(torch, pt))
    runs_base = phase("baselines", "Bellman-Ford and delta-stepping, n = "
                      "2^20", lambda: baselines_phase(torch, pt, runs))
    runs_dist = phase("distributed", "the edge-sharded backend, gnp "
                      "n = 2^20, worlds 1 (NCCL) and 2, 4 (gloo)",
                      lambda: distributed_phase(torch, pt, runs, dist_ref))
    runs_legacy = phase("legacy", "run_sssp, run_sssp_ell, "
                        "run_sssp_traced", lambda: legacy_phase(torch, pt,
                                                                runs))
    phase("parity", "card vs the port's CPU solve, 2^12 vertices",
          lambda: cpu_parity_phase(torch, pt))
    xd_launch = phase("xdeepfm", "scoring at the FULL config",
                      lambda: xdeepfm_phase(torch))
    attn_launch = phase("attention", "the ops.flash_attention entry point",
                        lambda: attention_entry_phase(torch))
    runs_lm = phase("lm", "LM serving: qwen3-32b and deepseek-moe-16b at "
                    "full width, smoke configs against the CPU",
                    lambda: lm_phase(torch, rec))
    runs_train = phase("train", "training: qwen3-32b and deepseek-moe-16b "
                       "at full width, xDeepFM FULL, smoke configs against "
                       "the CPU, the train launcher",
                       lambda: train_phase(torch))
    if args.profile:
        log("[profile] torch.profiler over the first rounds of each route")
        profile_phase(torch, pt)

    main_launch = {k: 0 for k in KERNELS}
    launch_runs = [k["launches"] for r in runs.values() for k in r.values()]
    for lc in (launch_runs + runs_dyn + runs_p2p + runs_bidi + runs_fleet
               + runs_serve + runs_launch + runs_base + runs_dist
               + runs_legacy + [xd_launch, attn_launch] + runs_lm
               + runs_train):
        for k, v in lc.items():
            main_launch[k] += v
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launch[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shapes": r["shapes"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
