#!/usr/bin/env python3
"""What the CIN kernel's float64 sum level costs, on one CUDA card.

    python3 tools/cin_sum_ab.py

``src/repro_torch/kernels/csrc/cin.cu`` sums t = sum_m W x_0 and acc +=
x_k * t over 8 values of h in float32, then adds acc into a float64 total
in shared memory.  This script builds that source as it stands and two
variants made from its text, in one process on one card:

- ``f32 total``: the same levels with the total in float32;
- ``f32 chain``: no total level, one float32 chain over every h.

It times each at B = 512 (serve_p99) and B = 65,536, layer 2's shape (H =
K = 200, M = 39, D = 10), by CUDA events (median), and prints each one's
largest error against the plain version in float64 (all rows at B = 512,
the last 2,048 rows at B = 65,536) on seeded unit-normal inputs.  Builds
go to ``build/cin_sum_ab/`` (gitignored).
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "cin.cu"
OUT = ROOT / "build" / "cin_sum_ab"

F32_TOTAL = [
    ("double* total = smem;",
     "float* total = reinterpret_cast<float*>(smem);"),
    ("reinterpret_cast<float*>(smem + kKt * kNc)", "total + kKt * kNc"),
    ("kKt * kNc * sizeof(double)", "kKt * kNc * sizeof(float)"),
]
VARIANTS = {
    "committed (f64 total)": [],
    "f32 total": F32_TOTAL,
    "f32 chain": F32_TOTAL + [("constexpr int kHc = 8;",
                               "constexpr int kHc = 1 << 30;")],
}


def build(torch) -> dict:
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = SRC.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"cin_sum_ab: {old!r} is not once in {SRC.name}")
            text = text.replace(old, new)
        cu, so = OUT / f"cin_{i}.cu", OUT / f"libcin_{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"cin_sum_ab: nvcc failed for {name}:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"[nvcc] {name}: {'; '.join(regs)}")
        fn = ctypes.CDLL(str(so)).cin_layer
        fn.argtypes = _build.SIGNATURES["cin_layer"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cin_sum_ab: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[device] {smi.stdout.strip()}")
    fns = build(torch)

    def call(fn, xk, x0, w):
        B, H, D = xk.shape
        out = torch.empty((B, w.shape[0], D), device="cuda")
        rc = fn(xk.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(),
                B, H, x0.shape[1], D, w.shape[0],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            sys.exit(f"cin_sum_ab: launch failed with error {rc}")
        return out

    def time_ms(fn, reps):
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

    g = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for B, reps, rows in ((512, 25, 512), (65536, 5, 2048)):
        xk, x0, w = (torch.randn(s, generator=g, device="cuda")
                     for s in ((B, 200, 10), (B, 39, 10), (200, 200, 39)))
        exact = ref.cin_layer_ref(xk[-rows:].double(), x0[-rows:].double(),
                                  w.double())
        cases.append((B, reps, rows, xk, x0, w, exact))
    for name, fn in fns.items():
        parts = []
        for B, reps, rows, xk, x0, w, exact in cases:
            err = float((call(fn, xk, x0, w)[-rows:].double() - exact)
                        .abs().max())
            ms = time_ms(lambda: call(fn, xk, x0, w), reps)
            parts.append(f"B={B}: {ms:.4f} ms, max_abs_err {err:.3e} "
                         f"(last {rows} rows)")
        print(f"{name:22s} " + " | ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
