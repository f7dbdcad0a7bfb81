#!/usr/bin/env python3
"""B1/B2's +inf fill and scatter as one cooperative launch or as two
launches, on one CUDA card.

    python3 tools/b1_fill_variants.py

Builds ``tools/b1_two_launch.cu`` with nvcc into ``build/tools/``: one
library with both forms of the tgt/cand entry and of the fused CSR entry,
the cooperative one of ``csrc/frontier_relax.cu`` (fill, grid barrier,
scatter) and the two-launch one (a fill kernel, then the scatter kernel).
Times them on ``chip_smoke.py``'s frontier inputs: a full cap-4096
buffer on the grid side 1024 (n = 2^20), B = 1 and 8.  Both forms are
first held bitwise against the plain version.  Prints the card's name and
power limit, then one line an entry and B: CUDA-event ms (median of 25
calls), device ms (torch.profiler, the kernels' own time) and the device
span of a call (first kernel's start to the last one's end, so the gap
between two launches counts), and device ops a call; then the
cooperative kernels' span on grids of 132 to 1,056 blocks.  Then the host cost
of a call of the B1 and B4 pair wrappers (B = 1, n = 2^20) and of their
parts: host-clock us a call over 2,000 calls in a row, no synchronize
between them (the device takes a few us a call, so the host sets the
pace).
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def build():
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools" / "libb1_two_launch.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                    "-o", str(out), str(ROOT / "tools" / "b1_two_launch.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    fns = {}
    for name in ("frontier_scatter_min_batch", "frontier_relax_csr"):
        for suffix in ("", "_two", "_grid"):
            f = getattr(lib, name + suffix)
            f.argtypes = _build.SIGNATURES[name][1] + (
                (ctypes.c_int,) if suffix == "_grid" else ())
            f.restype = ctypes.c_int
            fns[name + suffix] = f
    return fns


def span_ms(torch, fn, ops: int, reps: int = 25):
    """Median device span of one ``fn()`` of ``ops`` kernels: the first
    kernel's start to the last one's end, from the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ks = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if "CUDA" in str(getattr(e, "device_type", "")))
    if len(ks) != ops * reps:
        return float("nan")
    return statistics.median(ks[i + ops - 1][1] - ks[i][0]
                             for i in range(0, len(ks), ops)) / 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("b1_fill_variants: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import sssp
    from repro_torch.core import generators as gen
    from repro_torch.kernels import _build, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    fns = build()
    dev = torch.device("cuda", torch.cuda.current_device())
    n, src, dst, w = gen.grid(cs.GRID_SIDE, seed=0)
    g = sssp.build_graph(n, src, dst, w, device=dev)
    csr = g.csr()
    cap = cs.FRONTIER_CAP

    def call(name, args, lanes, *grid):
        out = torch.empty((lanes, g.n), dtype=torch.float32, device=dev)
        rc = fns[name](*args(out), dev.index, _build.raw_stream(dev), *grid)
        _build.check(rc, name)
        return out

    for B in (1, 8):
        x, mask, f_idx = cs.frontier_inputs(torch, g, B, cap, seed=B)
        tgt, cand = cs.gather_tgt_cand(torch, ref, csr, x, mask, f_idx)
        entries = {
            "tgt/cand": ("frontier_scatter_min_batch", lambda o: (
                tgt.data_ptr(), cand.data_ptr(), o.data_ptr(), B,
                tgt.numel(), g.n),
                ref.frontier_scatter_min_batch_ref(tgt, cand, g.n)),
            "fused csr": ("frontier_relax_csr", lambda o: (
                f_idx.data_ptr(), csr.indptr.data_ptr(), csr.dst.data_ptr(),
                csr.w.data_ptr(), x.data_ptr(), mask.data_ptr(),
                o.data_ptr(), B, cap, csr.max_out_deg, g.n),
                ref.frontier_relax_ref(x, mask, f_idx, csr.indptr, csr.dst,
                                       csr.w, csr.max_out_deg)),
        }
        for what, (name, args, want) in entries.items():
            cols = []
            for form, suffix, ops in (("cooperative", "", 1),
                                      ("two launches", "_two", 2)):
                fn = lambda: call(name + suffix, args, B)  # noqa: E731
                err = cs.max_abs_err(torch, fn(), want)
                if err != 0.0:
                    print(f"  {what} B={B} {form}: max_abs_err {err}",
                          flush=True)
                    return 1
                dev_ms, dev_ops = cs.device_profile(torch, fn)
                cols.append(f"{form} {cs.time_ms(torch, fn):.4f} card / "
                            f"{dev_ms:.4f} device / "
                            f"{span_ms(torch, fn, ops):.4f} span ms, "
                            f"{dev_ops:.1f} ops")
            print(f"  {what} B={B}: " + "; ".join(cols), flush=True)
            sweep = []
            for blocks in (132, 264, 528, 1056):
                fn = lambda: call(name + "_grid", args, B, blocks)  # noqa
                check_ok = cs.max_abs_err(torch, fn(), want) == 0.0
                sweep.append(f"{blocks} {span_ms(torch, fn, 1):.4f}"
                             + ("" if check_ok else " (WRONG)"))
            print(f"  {what} B={B} cooperative grid sweep, blocks and "
                  f"span ms: " + ", ".join(sweep), flush=True)
    host_costs(torch, g, csr, cap)
    return 0


def host_costs(torch, g, csr, cap):
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.frontier_relax import frontier_scatter_min
    from repro_torch.kernels.segment_min import (MAX_BLOCKS, _scratch,
                                                 masked_min_pair)
    dev = g.device
    x, mask, f_idx = cs.frontier_inputs(torch, g, 1, cap, seed=1)
    tgt, cand = cs.gather_tgt_cand(torch, ref, csr, x, mask, f_idx)
    c0, add = cand[0].contiguous(), g.out_weight
    masked_min_pair(x, mask, add)                   # builds, makes scratch
    stream = _build.raw_stream(dev)
    partial, ticket = _scratch[(dev.index, stream)]
    out2 = torch.empty((1, 2), device=dev)
    out1 = torch.empty((g.n,), device=dev)
    pair_fn = _build.function("masked_min_pair")
    scat_fn = _build.function("frontier_scatter_min_batch")
    pair_args = (x.data_ptr(), mask.data_ptr(), add.data_ptr(),
                 partial.data_ptr(), ticket.data_ptr(), out2.data_ptr(), 1,
                 g.n, MAX_BLOCKS, dev.index, stream)
    scat_args = (tgt.data_ptr(), c0.data_ptr(), out1.data_ptr(), 1,
                 tgt.numel(), g.n, dev.index, stream)
    parts = {
        "masked_min_pair wrapper": lambda: masked_min_pair(x, mask, add),
        "masked_min_pair's C call alone": lambda: pair_fn(*pair_args),
        "frontier_scatter_min wrapper": lambda: frontier_scatter_min(
            tgt, c0, g.n),
        "frontier_scatter_min's C call alone": lambda: scat_fn(
            *scat_args),
        "torch.empty((1, 2))": lambda: torch.empty((1, 2), device=dev),
        "torch.empty((n,))": lambda: torch.empty((g.n,), device=dev),
        "raw_stream": lambda: _build.raw_stream(dev),
        "torch.full((1, n + 1), inf)": lambda: torch.full(
            (1, g.n + 1), float("inf"), device=dev),
    }
    for what, fn in parts.items():
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print(f"  host {what}: {us:.2f} us a call", flush=True)


if __name__ == "__main__":
    sys.exit(main())
