#!/usr/bin/env python3
"""What bounds B5's and B6's forward kernels: ablations of
``csrc/cin.cu``'s ``cin_layer`` and ``csrc/flash_attn.cu``'s bf16 path on
one CUDA card.

    python3 tools/fwd_ablations.py [--only B5|B6]

Builds copies of the kernels' sources into ``build/tools/fwd_ablations/``,
each with one change, and times every copy through the wrappers (CUDA
events, median of 10 calls after 3).  A copy marked "held" is checked
against the plain version first (the kernel's tolerances); the others
leave out work and are wrong by design.

B6, bf16 causal, at the ``[lm]`` qwen3-32b prefill layer (B 8, H 64, S
1,024, d 128) and at B 1, H 64, S 4,096:

- ``kernel``: unchanged (held);
- ``2 stages``: a 2-deep K/V ring (held);
- ``no turns``: the two consumer warpgroups issue their products when
  they are ready (held);
- ``heaviest first across heads``: the items ordered by query tile
  first, the heads' K and V then shared by no blocks in flight (held);
- ``no V loads``: the producer signals V tiles without loading them
  (half the K/V bytes from L2);
- ``no exp2``: the softmax's exponentials replaced by a multiply-add;
- ``no P V``: the second product left out.

B5 at the input-gradient shapes of an H-200 layer at B 65,536 (dx_k: H'
200, M' 39, K' 200; dx_0: H' 200, M' 200, K' 39) and at B 512, H 200:

- ``kernel``: unchanged (held);
- ``2 stages``: a 2-deep ring where 3 fit (held; M' <= 103; the same
  kernel at M' = 200);
- ``flush every 8 stages``: twice the Kahan period (held);
- ``no products``: the consumers take each stage and release it;
- ``no Z``: the producer forms and stores no Z (the W copies stay);
- ``no split``: hi = x, lo = 0 (no TF32 rounding);
- ``no x0 loads``: Z formed from x_k alone;
- ``no fence``: the producer's proxy fence before it arrives left out.

Prints the card's name and power limit, then one line a shape and copy.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ATTN = {
    "kernel": [],
    "2 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "no turns": [
        ("  auto take = [&]() { named_sync(3 + wg, 256); };",
         "  auto take = [&]() {};"),
        ("    if (!(last && wg == 1)) named_arrive(4 - wg, 256);",
         "    (void)last;"),
        ("  if (wg == 1) named_arrive(3, 256);", "")],
    "heaviest first across heads": [(
        "  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);\n"
        "  const long long bh = blockIdx.x / n_qt;",
        "  const int qt = n_qt - 1 - (int)(blockIdx.x / (gridDim.x / n_qt));\n"
        "  const long long bh = blockIdx.x % (gridDim.x / n_qt);")],
    "no V loads": [(
        "        mbar_expect(&v_full[st], C::KT);\n"
        "        for (int r = 0; r < C::NR; ++r)\n"
        "          tma_load_2d(sm + C::V_OFF + st * C::KT + r * kBn * 128, "
        "&tm_v,\n                      64 * r, (int)row, &v_full[st]);",
        "        mbar_arrive(&v_full[st]);")],
    "no exp2": [(
        "        const float x = ex2(fmaf(s[4 * i + e], scale_log2, "
        "nm[e >> 1]));",
        "        const float x = fmaf(s[4 * i + e], scale_log2, nm[e >> 1]);")],
    "no P V": [(
        "      pv<DMAX>(acc, p[kk], at(v_b, st * C::KT + kk * 2048));",
        "      (void)kk;")],
}
ATTN_HELD = ("kernel", "2 stages", "no turns",
             "heaviest first across heads")
CIN = {
    "kernel": [],
    "2 stages": [("constexpr int kFStagesMax = 3;",
                  "constexpr int kFStagesMax = 2;")],
    "flush every 8 stages": [("constexpr int kFFlush = 4;",
                              "constexpr int kFFlush = 8;")],
    "no products": [
        ("        wgmma_tf32<N>(acc, at(z_a, so + kFZ + o), at(w_b, so + o));"
         "  // lo hi", ""),
        ("        wgmma_tf32<N>(acc, at(z_a, so + o), at(w_b, so + WT + o));"
         "   // hi lo", ""),
        ("        wgmma_tf32<N>(acc, at(z_a, so + o), at(w_b, so + o));"
         "        // hi hi", "")],
    "no Z": [("      for (int q = 0; q < ZJ / 4; ++q) {",
              "      for (int q = 0; q < 0; ++q) {")],
    "no split": [("  hi = tf32(x);\n  lo = tf32(x - __uint_as_float(hi));",
                  "  hi = __float_as_uint(x);\n  lo = 0u;")],
    "no x0 loads": [(
        "z[i] = (next ? xb : xa) * x0s[(m + i - (next ? M : 0)) * kFCols + p];",
        "z[i] = (next ? xb : xa) * (float)(m + i);")],
    "no fence": [(
        "        *reinterpret_cast<uint4*>(zs + kFZ + off) = lo;\n      }\n"
        "      fence_async_shared();", "        *reinterpret_cast<uint4*>"
        "(zs + kFZ + off) = lo;\n      }")],
}
CIN_HELD = ("kernel", "2 stages", "flush every 8 stages")


def median_ms(torch, fn, reps=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("B5", "B6"))
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, cin, flash_attn, ref
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.build_all()
    out = ROOT / "build" / "tools" / "fwd_ablations"
    attn_fns = {} if args.only == "B5" else {
        name: _build.build_variant("flash_attention", edits,
                                   out / ("attn_" + name.replace(" ", "_")))
        for name, edits in ATTN.items()}
    cin_fns = {} if args.only == "B6" else {
        name: _build.build_variant("cin_layer", edits,
                                   out / ("cin_" + name.replace(" ", "_")))
        for name, edits in CIN.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    for a in (cs.LM_ATTN_SHAPE, cs.ATTN_SHAPE) if attn_fns else ():
        q, k, v = cs.attn_inputs(torch, torch.bfloat16, a=a)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        for name, f in attn_fns.items():
            _build.use("flash_attention", f)
            got = flash_attn.flash_attention(q, k, v, True)
            tag = ""
            if name in ATTN_HELD:
                ok = torch.allclose(got.float(), want.float(),
                                    **cs.ATTN_TOL["bfloat16"])
                tag = ", held" if ok else ", DISAGREES"
            ms = median_ms(torch, lambda: flash_attn.flash_attention(
                q, k, v, True))
            print(f"B6 bf16 B={a['B']} H={a['H']} S={a['S']} d={a['d']} "
                  f"causal, {name}: {ms:.4f} ms{tag}", flush=True)
        _build.use("flash_attention")
        del q, k, v, want
    cases = []
    for B in (65536, 512) if cin_fns else ():
        gr, xk, x0 = (torch.randn(s, generator=g, device="cuda") for s in
                      ((B, 200, 10), (B, 200, 10), (B, 39, 10)))
        w = torch.randn((200, 200, 39), generator=g, device="cuda")
        cases.append((f"dx_k B={B} (H'=200 M'=39 K'=200)", gr, x0,
                      w.permute(1, 0, 2).contiguous()))
        cases.append((f"dx_0 B={B} (H'=200 M'=200 K'=39)", gr, xk,
                      w.permute(2, 0, 1).contiguous()))
    for what, xa, xb, ww in cases:
        rows = slice(0, 256)
        want = ref.cin_layer_ref(xa[rows].double(), xb[rows].double(),
                                 ww.double())
        for name, f in cin_fns.items():
            _build.use("cin_layer", f)
            try:
                got = cin._forward(xa, xb, ww)
            except RuntimeError as e:
                print(f"B5 {what}, {name}: not run ({e})", flush=True)
                continue
            tag = ""
            if name in CIN_HELD:
                tol = 3e-4 * float(want.abs().max())
                ok = float((got[rows].double() - want).abs().max()) <= tol
                tag = ", held" if ok else ", DISAGREES"
            ms = median_ms(torch, lambda: cin._forward(xa, xb, ww))
            print(f"B5 {what}, {name}: {ms:.4f} ms{tag}", flush=True)
        _build.use("cin_layer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
