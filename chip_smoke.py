#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # every phase, one CUDA card
    python3 chip_smoke.py --profile  # and a torch.profiler breakdown

Phases, each failing the run (non-zero exit) if it fails:

 1. device report: the card's name and power limit from nvidia-smi;
 2. build: every kernel of ``src/repro_torch/kernels/csrc`` with nvcc
    into ``build/repro_torch`` (timed);
 3. kernels: each CUDA kernel against its plain PyTorch version on the
    card, with tolerance 0 (min, mask and one f32 add are exact), at the
    main path's shapes and on edge cases; median times by CUDA events;
 4. main path at full size through ``repro_torch.sssp.Solver``:
    grid(side=1024) via "auto" (must route to frontier), gnp(2^20, 8) via
    "auto" (must route to segment) and via "pallas"; ``solve`` and an
    8-source ``solve_batch`` each, with the kernels' launch counts read
    around each run; then distances against scipy's float64 Dijkstra,
    the backends bitwise against each other, and the card bitwise
    against the port's own CPU solve on 2^14-vertex graphs of the seven
    generator families.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository, the script exits non-zero before printing either.
"""
from __future__ import annotations

import argparse
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
REPS = 25
DEVICE = "cuda"
GRID_SIDE = 1024              # grid(side=1024): n = 2^20, 4.2 M edges
GNP_N = 1 << 20               # gnp(2^20, avg_deg=8): 8.4 M edges
FRONTIER_CAP = 4096           # the Solver's default cap at n = 2^20
PARITY_N = 1 << 14            # card vs CPU parity graphs


def log(*a):
    print(*a, flush=True)


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


def device_ms(torch, fn, reps: int = REPS) -> float:
    """Device time of one ``fn()``: the kernels' own time summed over
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
    return sum(_self_device_us(e) for e in _device_events(prof)
               ) / reps / 1e3


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


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def frontier_inputs(torch, ops, g, csr, B: int, cap: int, seed: int):
    """tgt/cand of the shared-frontier relax on a real frontier buffer of
    ``cap`` vertices, built by the same gather ``ops.frontier_relax_b``
    does before it calls the kernel."""
    rng = np.random.default_rng(seed)
    dev = g.device
    f_idx = torch.from_numpy(np.sort(rng.choice(g.n, cap, replace=False))
                             .astype(np.int32)).to(dev)
    x = torch.from_numpy(rng.uniform(0, 50, (B, g.n)).astype(np.float32)
                         ).to(dev)
    mask = torch.from_numpy(rng.random((B, g.n)) < 0.7).to(dev)
    u, cell, epos = ops._out_cells(csr, f_idx)
    tgt = torch.where(cell, csr.dst[epos], g.n).to(torch.int32).contiguous()
    lane_ok = cell[None] & mask[:, u][:, :, None]
    cand = torch.where(lane_ok, x[:, u][:, :, None] + csr.w[epos][None],
                       float("inf")).contiguous()
    return tgt, cand


def kernel_phase(torch, pt):
    from repro_torch.kernels import ref
    from repro_torch.kernels.frontier_relax import (
        frontier_scatter_min, frontier_scatter_min_batch)
    from repro_torch.kernels.relax import relax_ell
    from repro_torch.kernels.segment_min import masked_min
    from repro_torch.kernels import ops
    gen, sssp = pt["generators"], pt["sssp"]
    dev = torch.device(DEVICE)
    rec = {}
    inf = float("inf")

    def held(name, got, want, what):
        err = max_abs_err(torch, got, want)
        log(f"  {name:28s} {what:44s} max_abs_err={err}")
        check(err == 0.0, f"{name} disagrees with its plain version "
                          f"({what}): max_abs_err={err}")
        r = rec.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    # --- B2 / B1 at the grid-1024 frontier shapes ----------------------
    n, src, dst, w = gen.grid(GRID_SIDE, seed=0)
    g = sssp.build_graph(n, src, dst, w, device=dev)
    csr = g.csr()
    cap = FRONTIER_CAP
    log(f"[kernels] grid side 1024: n={g.n} e={g.e} cap={cap} "
        f"max_out_deg={csr.max_out_deg}")
    for B in (1, 8):
        tgt, cand = frontier_inputs(torch, ops, g, csr, B, cap, seed=B)
        got = frontier_scatter_min_batch(tgt, cand, g.n)
        want = ref.frontier_scatter_min_batch_ref(tgt, cand, g.n)
        held("frontier_scatter_min_batch", got, want,
             f"B={B} tgt{tuple(tgt.shape)}")
        ms = time_ms(torch, lambda: frontier_scatter_min_batch(tgt, cand,
                                                              g.n))
        plain = time_ms(torch, lambda: ref.frontier_scatter_min_batch_ref(
            tgt, cand, g.n))
        idx = torch.where((tgt >= 0) & (tgt < g.n), tgt.long(), g.n
                          ).reshape(1, -1).expand(B, -1)
        vals = cand.reshape(B, -1)
        lib_out = torch.full((B, g.n + 1), inf, device=dev)
        lib = time_ms(torch, lambda: lib_out.scatter_reduce_(
            1, idx, vals, "amin"))
        check(torch.equal(lib_out[:, :g.n], want), "scatter_reduce_ "
              "yardstick disagrees with the plain version")
        dt = dict(
            kernel=device_ms(torch, lambda: frontier_scatter_min_batch(
                tgt, cand, g.n)),
            plain=device_ms(torch, lambda: ref.frontier_scatter_min_batch_ref(
                tgt, cand, g.n)),
            library=device_ms(torch, lambda: lib_out.scatter_reduce_(
                1, idx, vals, "amin")))
        cells = tgt.numel()
        b_ms, b_by = bound(4 * cells + 4 * B * cells + 4 * B * g.n,
                           B * cells)
        log(f"  frontier_scatter_min_batch B={B}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, scatter_reduce_ {lib:.4f} ms (events); "
            f"device {dt['kernel']:.4f} / {dt['plain']:.4f} / "
            f"{dt['library']:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
        rec["frontier_scatter_min_batch"].update(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib)
        if B == 1:
            got1 = frontier_scatter_min(tgt, cand[0].contiguous(), g.n)
            held("frontier_scatter_min", got1, want[0], "B=1 (B1 wrapper)")
            c0 = cand[0].contiguous()
            ms1 = time_ms(torch, lambda: frontier_scatter_min(tgt, c0, g.n))
            pl1 = time_ms(torch, lambda: ref.frontier_scatter_min_ref(
                tgt, c0, g.n))
            lib1 = time_ms(torch, lambda: lib_out[:1].scatter_reduce_(
                1, idx[:1], vals[:1], "amin"))
            dt1 = dict(
                kernel=device_ms(torch, lambda: frontier_scatter_min(
                    tgt, c0, g.n)),
                plain=device_ms(torch, lambda: ref.frontier_scatter_min_ref(
                    tgt, c0, g.n)),
                library=device_ms(torch, lambda: lib_out[:1].scatter_reduce_(
                    1, idx[:1], vals[:1], "amin")))
            log(f"  frontier_scatter_min B=1: kernel {ms1:.4f} ms, plain "
                f"{pl1:.4f} ms, scatter_reduce_ {lib1:.4f} ms (events); "
                f"device {dt1['kernel']:.4f} / {dt1['plain']:.4f} / "
                f"{dt1['library']:.4f} ms")
            rec["frontier_scatter_min"].update(
                ms=ms1, plain_ms=pl1, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib1)
    # edge cases: all padding, all +inf, n not a multiple of the block
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

    # --- B3 / B4 at the gnp 2^20 ELL shapes ----------------------------
    n, src, dst, w = gen.gnp(GNP_N, avg_deg=8.0, seed=0)
    ell = sssp.build_ell(n, src, dst, w, device=dev)
    log(f"[kernels] gnp n={n} e={len(src)} ELL n_pad={ell.n_pad} "
        f"deg_pad={ell.deg_pad}")
    rng = np.random.default_rng(7)
    for B in (1, 8):
        x = torch.from_numpy(rng.uniform(0, 50, (B, n)).astype(np.float32)
                             ).to(dev)
        x[torch.from_numpy(rng.random((B, n)) < 0.3).to(dev)] = inf
        mask = torch.from_numpy(rng.random((B, n)) < 0.5).to(dev)
        got = relax_ell(x, mask, ell.in_src, ell.in_w, n)
        want = ref.relax_ell_ref(x, mask, ell.in_src, ell.in_w, n)
        held("relax_ell", got, want, f"B={B} [{ell.n_pad}, {ell.deg_pad}]")
        ms = time_ms(torch, lambda: relax_ell(x, mask, ell.in_src,
                                              ell.in_w, n))
        plain = time_ms(torch, lambda: ref.relax_ell_ref(
            x, mask, ell.in_src, ell.in_w, n), reps=5, warmup=1)
        dt = dict(kernel=device_ms(torch, lambda: relax_ell(
            x, mask, ell.in_src, ell.in_w, n)), plain=device_ms(
            torch, lambda: ref.relax_ell_ref(x, mask, ell.in_src, ell.in_w,
                                             n), reps=5))
        b_ms, b_by = bound(8 * n * ell.deg_pad + 9 * B * n,
                           2 * B * n * ell.deg_pad)
        log(f"  relax_ell B={B}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"(events); device {dt['kernel']:.4f} / {dt['plain']:.4f} ms; "
            f"bound {b_ms:.4f} ms ({b_by})")
        rec["relax_ell"].update(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None)
        got = masked_min(x, mask)
        want = ref.masked_min_ref(x, mask)
        held("masked_min", got, want, f"B={B} n={n}")
        ms = time_ms(torch, lambda: masked_min(x, mask))
        plain = time_ms(torch, lambda: ref.masked_min_ref(x, mask))
        dt = dict(kernel=device_ms(torch, lambda: masked_min(x, mask)),
                   plain=device_ms(torch, lambda: ref.masked_min_ref(x, mask)))
        b_ms, b_by = bound(5 * B * n + 4 * B, B * n)
        log(f"  masked_min B={B}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"(events); device {dt['kernel']:.4f} / {dt['plain']:.4f} ms; "
            f"bound {b_ms:.4f} ms ({b_by})")
        rec["masked_min"].update(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None)
    # edge cases: empty masks, all-padding ELL rows, odd n
    x = torch.rand((3, 1001), device=dev) * 9
    none = torch.zeros((3, 1001), dtype=torch.bool, device=dev)
    some = torch.rand((3, 1001), device=dev) < 0.4
    some[1] = False
    held("masked_min", masked_min(x, none), ref.masked_min_ref(x, none),
         "empty masks, n=1001")
    held("masked_min", masked_min(x, some), ref.masked_min_ref(x, some),
         "one empty lane, n=1001")
    s_src = rng.integers(0, 1001, 4000)
    s_dst = rng.integers(0, 1001, 4000)
    keep = (s_src != s_dst) & (s_dst % 7 != 0)      # rows d%7==0: padding
    small = sssp.build_ell(1001, s_src[keep], s_dst[keep],
                           rng.uniform(0.05, 1, keep.sum()), device=dev)
    held("relax_ell", relax_ell(x, some, small.in_src, small.in_w, 1001),
         ref.relax_ell_ref(x, some, small.in_src, small.in_w, 1001),
         "n=1001, empty lane, all-padding rows")
    held("relax_ell", relax_ell(x, none, small.in_src, small.in_w, 1001),
         ref.relax_ell_ref(x, none, small.in_src, small.in_w, 1001),
         "n=1001, empty masks")
    torch.cuda.synchronize()
    return rec


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
    gen, sssp = pt["generators"], pt["sssp"]
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(2024)
    runs = {}

    # --- grid side 1024: auto -> frontier ------------------------------
    n, src, dst, w = gen.grid(GRID_SIDE, seed=0)
    g = sssp.build_graph(n, src, dst, w, device=dev)
    batch = [int(s) for s in rng.choice(n, 8, replace=False)]
    s0 = batch[0]
    solver = sssp.Solver(g, backend="auto")
    log(f"[main] grid side 1024: n={n} e={g.e}, auto -> {solver.backend} "
        f"(cap {solver.frontier_cap})")
    check(solver.backend == "frontier", "auto did not route grid to "
                                        "frontier")
    runs["grid/frontier"] = r = solve_timed(torch, solver, "grid frontier",
                                            s0, batch)
    check(r["solve"]["launches"]["frontier_scatter_min_batch"] > 0 and
          r["solve_batch"]["launches"]["frontier_scatter_min_batch"] > 0,
          "the frontier route launched no scatter-min kernel")
    grid_front = r["solve"]["res"]
    against_scipy(torch, [grid_front.dist, r["solve_batch"]["res"].dist[1]],
                  n, src, dst, w, [s0, batch[1]], "grid frontier")
    check(torch.equal(r["solve_batch"]["res"].dist[0], grid_front.dist),
          "grid: batch lane 0 differs from the single solve")
    # backends bitwise on the same graph
    for be in ("segment", "pallas"):
        other = sssp.Solver(g, backend=be)
        t0 = time.perf_counter()
        res = other.solve(s0)
        torch.cuda.synchronize()
        log(f"  grid {be} solve: {(time.perf_counter() - t0) * 1e3:.1f} ms,"
            f" rounds {res.rounds}")
        check(same(torch, res, grid_front), f"grid: {be} differs from "
                                            "frontier")
    log("  grid: segment, pallas and frontier bitwise identical "
        "(dist, C, fixed, rounds, fixed_by)")
    del solver, other, g

    # --- gnp 2^20: auto -> segment, and pallas ------------------------
    n, src, dst, w = gen.gnp(GNP_N, avg_deg=8.0, seed=0)
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
        lc = rp[kind]["launches"]
        check(lc["relax_ell"] > 0 and lc["masked_min"] > 0,
              f"the pallas route's {kind} launched no ELL kernel")
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


def cpu_parity_phase(torch, pt):
    """The card's solves equal the port's CPU solves (plain versions)
    bitwise on 2^14-vertex graphs of every family, on the auto route and
    the pallas route.  The card's solves run under torch's sync debug
    mode, which names every host sync the engine's own count misses."""
    gen, sssp = pt["generators"], pt["sssp"]
    from repro_torch.kernels import _build
    n = PARITY_N
    for family in gen.FAMILIES:
        nn, src, dst, w = gen.make(family, n, seed=1)
        g_cpu = sssp.build_graph(nn, src, dst, w, device="cpu")
        g_gpu = g_cpu.to(DEVICE)
        sources = [0, nn // 2]
        for be in ("auto", "pallas"):
            s_gpu = sssp.Solver(g_gpu, backend=be)
            s_cpu = sssp.Solver(g_cpu, backend=be, device="cpu")
            _build.reset_launch_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    a = s_gpu.solve_batch(sources)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            # SyncCounter.read lifts the debug mode for its own reads, so
            # every flagged call is a host sync the engine does not count
            hidden = sorted({f"{Path(c.filename).name}:{c.lineno}"
                             for c in caught
                             if "synchroniz" in str(c.message)})
            launches = {k: v for k, v in _build.launch_counts().items() if v}
            b = s_cpu.solve_batch(sources)
            ok = (torch.equal(a.dist.cpu(), b.dist)
                  and torch.equal(a.C.cpu(), b.C)
                  and torch.equal(a.fixed.cpu(), b.fixed)
                  and np.array_equal(a.rounds, b.rounds)
                  and a.fixed_by == b.fixed_by
                  and (a.edges_relaxed is None
                       or np.array_equal(a.edges_relaxed, b.edges_relaxed)))
            log(f"  {family:10s} {s_gpu.backend:8s} card == cpu: {ok} "
                f"(rounds {a.rounds.tolist()}, launches {launches}, "
                f"host syncs {a.host_syncs}, uncounted {hidden})")
            check(ok, f"{family}/{s_gpu.backend}: card and CPU differ")
            check(not hidden, f"{family}/{s_gpu.backend}: host syncs the "
                              f"engine does not count at {hidden}")
            if s_gpu.backend in ("frontier", "pallas"):
                check(bool(launches), f"{family}/{s_gpu.backend}: no "
                                      "kernel launched")


def profile_phase(torch, pt, rounds: int = 400):
    """Device time by kernel over the first ``rounds`` rounds of each
    main-path route (``torch.profiler``, CUDA activity), the device's busy
    and idle share of the wall time, and launches a round."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    gen, sssp = pt["generators"], pt["sssp"]
    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(sssp.SP4_CONFIG, max_rounds=rounds)
    n, src, dst, w = gen.grid(GRID_SIDE, seed=0)
    grid = sssp.build_graph(n, src, dst, w, device=dev)
    n, src, dst, w = gen.gnp(GNP_N, avg_deg=8.0, seed=0)
    gnp = sssp.build_graph(n, src, dst, w, device=dev)
    for what, g, be in (("grid frontier", grid, "auto"),
                        ("gnp segment", gnp, "auto"),
                        ("gnp pallas", gnp, "pallas")):
        solver = sssp.Solver(g, cfg, backend=be)
        for kind, run in (("solve", lambda: solver.solve(1)),
                          ("solve_batch", lambda: solver.solve_batch(
                              [1, 5, 9, 13, 17, 21, 25, 29]))):
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            r = (res.rounds if kind == "solve" else int(res.rounds.max()))
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


KERNELS = {
    "frontier_scatter_min": (
        "src/repro_torch/kernels/csrc/frontier_relax.cu",
        "src/repro/kernels/frontier_relax.py:117"),
    "frontier_scatter_min_batch": (
        "src/repro_torch/kernels/csrc/frontier_relax.cu",
        "src/repro/kernels/frontier_relax.py:78"),
    "relax_ell": ("src/repro_torch/kernels/csrc/relax.cu",
                  "src/repro/kernels/relax.py:44"),
    "masked_min": ("src/repro_torch/kernels/csrc/segment_min.cu",
                   "src/repro/kernels/segment_min.py:33"),
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

    log("[kernels] each CUDA kernel vs its plain version, tolerance 0")
    rec = kernel_phase(torch, pt)
    # launch counts: set to 0 right before each main-path run and read
    # right after (solve_timed)
    runs = main_path(torch, pt)
    log("[parity] card vs the port's CPU solve, 2^14 vertices")
    cpu_parity_phase(torch, pt)
    if args.profile:
        log("[profile] torch.profiler over the first rounds of each route")
        profile_phase(torch, pt)

    main_launch = {k: 0 for k in KERNELS}
    for r in runs.values():
        for kind in ("solve", "solve_batch"):
            for k, v in r[kind]["launches"].items():
                main_launch[k] += v
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launch[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
