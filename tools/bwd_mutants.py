#!/usr/bin/env python3
"""Mutation check of the two backward kernels, on one CUDA card.

    python3 tools/bwd_mutants.py

Copies ``src/repro_torch/kernels/csrc`` into ``build/tools/mutants/``,
plants one fault in each copy and builds it with nvcc beside an unchanged
copy:

- ``flash_attn_bwd.cu``: the last key block of each head drops its dQ
  reduce-add, so dQ misses those keys' terms;
- ``cin.cu``: every part of ``cin_weight_grad``'s reduction drops its last
  stage of 32 columns.

Each library is swapped into the wrapper in turn (its ctypes function
takes the place of the built one), and the wrapper's result is held
against the plain version the way ``chip_smoke.py`` holds it: B6's dQ by
``bf16_grad_check`` at the [train] qwen3-32b layer (bf16, B 4, H 64, S
1,024, d 128, causal), B5's dW by ``CIN_GRAD_TOL`` (3e-4) of the largest
magnitude of float64 at B 512, H 39 (11 parts).  The unchanged copies
must pass and the mutants must fail; prints one line a library and the
card's name and power limit, and exits 1 if a check does not see a
planted fault.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MUTANTS = {
    "flash_attention_bwd": (
        "flash_attn_bwd.cu",
        "      if (tw == 0) {\n        bulk_reduce_add(",
        "      if (tw == 0 && b.j0 + kBk < b.Sk) {\n        bulk_reduce_add("),
    "cin_weight_grad": (
        "cin.cu",
        "  const int nst = min(cps, n_stages - st0);",
        "  const int nst = min(cps, n_stages - st0) - 1;"),
}


def attn_case(torch):
    import chip_smoke as cs
    from repro_torch.kernels import flash_attn, ref
    a = cs.TRAIN_ATTN_SHAPE
    q, k, v = cs.attn_inputs(torch, torch.bfloat16, seed=3, a=a)
    do = torch.randn(q.shape, generator=torch.Generator(
        device="cuda").manual_seed(4), device="cuda").to(torch.bfloat16)
    o, lse = flash_attn._forward(q, k, v, True, with_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True)[0]

    def held():
        got = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, True)[0]
        ok, worst, _ = cs.bf16_grad_check(torch, got, want)
        return ok, f"dQ largest error / allowance {worst:.3f}"
    return held


def cin_case(torch):
    import chip_smoke as cs
    from repro_torch.kernels import cin, ref
    g = torch.Generator(device="cuda").manual_seed(6)
    B, H, M, D, K = 512, 39, 39, 10, 200
    up, xk, x0 = (torch.randn(s, generator=g, device="cuda")
                  for s in ((B, K, D), (B, H, D), (B, M, D)))
    exact = ref.cin_weight_grad_ref(up.double(), xk.double(), x0.double())
    allow = cs.CIN_GRAD_TOL * float(exact.abs().max())

    def held():
        err = float((cin.cin_weight_grad(up, xk, x0).double()
                     - exact).abs().max())
        return err <= allow, (f"dW max_abs_err {err:.3e} against "
                              f"{allow:.3e} ({cs.CIN_GRAD_TOL:g} x max), "
                              f"parts {cin.wgrad_plan(B, H, M, D, K)[0]}")
    return held


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.build_all()
    failed = False
    for fn, case in (("flash_attention_bwd", attn_case),
                     ("cin_weight_grad", cin_case)):
        held = case(torch)
        for mutate in (False, True):
            src, anchor, planted = MUTANTS[fn]
            _build.use(fn, _build.build_variant(
                fn, [(anchor, planted)] if mutate else [],
                ROOT / "build" / "tools" / "mutants" / (
                    fn + ("_mutant" if mutate else "_base"))))
            ok, what = held()
            torch.cuda.synchronize()
            right = ok != mutate
            failed = failed or not right
            print(f"{fn} {'mutant' if mutate else 'unchanged'} "
                  f"({src}): {what}: "
                  f"{'passes' if ok else 'fails'} the check "
                  f"({'as it should' if right else 'WRONG'})")
        _build.use(fn)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
