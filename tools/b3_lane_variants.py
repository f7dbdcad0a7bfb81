#!/usr/bin/env python3
"""B3 (the port's ELL relax) with and without its lane pre-pass, on one
CUDA card.

    python3 tools/b3_lane_variants.py

Builds ``tools/b3_unpacked.cu`` (``csrc/relax.cu`` with the pre-pass left
out: each live cell reads ``x`` and ``src_mask`` in place) with nvcc into
``build/tools/``, and times it beside the port's ``relax_ell`` (pre-pass
and relax) at the shapes ``chip_smoke.py`` times B3 at: the grid side-1024
ELL at B = 1 and the gnp 2^20 ELL at B = 1 and 8.  Both are first held
bitwise against the plain version.  Prints the card's name and power
limit, then one line a shape: CUDA-event ms (median of 25 calls) and
device ms (torch.profiler) of each variant, the packed one's split into
its two kernels.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def build_unpacked():
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools" / "libb3_unpacked.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "tools" / "b3_unpacked.cu")], check=True)
    fn = ctypes.CDLL(str(out)).relax_ell_unpacked
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = (P, P, P, P, P, P, I, I, I, P)
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("b3_lane_variants: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import sssp
    from repro_torch.core import generators as gen
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.relax import relax_ell
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.build_all()
    unpacked_fn = build_unpacked()
    dev = torch.device("cuda")
    inf = float("inf")

    def unpacked(x, mask, ell):
        out = torch.empty_like(x)
        rc = unpacked_fn(x.data_ptr(), mask.data_ptr(), ell.in_src.data_ptr(),
                         ell.in_w.data_ptr(), ell.row_len.data_ptr(),
                         out.data_ptr(), x.shape[0], ell.n, ell.deg_pad,
                         _build.raw_stream(x.device))
        _build.check(rc, "relax_ell_unpacked")
        return out

    def kernel_ms(fn, reps=cs.REPS):
        """Device ms a call of each kernel fn() launches, by name."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in cs._device_events(prof):
            m = re.search(r"(\w+)(?:<[^>]*>)?\(", e.key)
            name = m.group(1) if m else e.key[:24]
            out[name] = (out.get(name, 0.0)
                         + cs._self_device_us(e) / reps / 1e3)
        return out

    graphs = (("grid", gen.grid(cs.GRID_SIDE, seed=0), (1,)),
              ("gnp", gen.gnp(cs.GNP_N, avg_deg=8.0, seed=0), (1, 8)))
    for what, (n, src, dst, w), lanes in graphs:
        ell = sssp.build_ell(n, src, dst, w, device=dev)
        for B in lanes:
            rng = np.random.default_rng(7 + B)
            x = torch.from_numpy(rng.uniform(0, 50, (B, n)).astype(
                np.float32)).to(dev)
            x[torch.from_numpy(rng.random((B, n)) < 0.3).to(dev)] = inf
            mask = torch.from_numpy(rng.random((B, n)) < 0.5).to(dev)
            want = ref.relax_ell_ref(x, mask, ell.in_src, ell.in_w, n)

            def packed():
                return relax_ell(x, mask, ell.in_src, ell.in_w, n,
                                 ell.row_len)
            cs.check(torch.equal(packed(), want), f"{what} B={B}: packed "
                     "differs from the plain version")
            cs.check(torch.equal(unpacked(x, mask, ell), want),
                     f"{what} B={B}: unpacked differs from the plain version")
            p_ms = cs.time_ms(torch, packed)
            u_ms = cs.time_ms(torch, lambda: unpacked(x, mask, ell))
            p_dev = kernel_ms(packed)
            u_dev = kernel_ms(lambda: unpacked(x, mask, ell))
            parts = ", ".join(f"{k} {v:.4f}" for k, v in p_dev.items())
            print(f"{what} B={B}: packed {p_ms:.4f} ms (events), device "
                  f"{sum(p_dev.values()):.4f} ms ({parts}); unpacked "
                  f"{u_ms:.4f} ms (events), device "
                  f"{sum(u_dev.values()):.4f} ms", flush=True)
        del ell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
