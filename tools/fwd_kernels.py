#!/usr/bin/env python3
"""B5's and B6's forward kernels on one CUDA card: held against their
plain versions, then timed, for the ``src`` of a checkout.

    python3 tools/fwd_kernels.py [--src DIR] [--quick] [--out FILE]

``--src`` imports ``repro_torch`` from DIR (default: this checkout's
``src``), so that a call can time the parent's kernels beside these
(parent, change, change, parent); the helpers and tolerances come from
this checkout's ``chip_smoke.py``.  Prints the card's name and power
limit, what ``nvcc -Xptxas -v`` says of the two kernels' sources
(registers, spills, warnings), then one line a check and one a timed
shape, and with ``--out`` writes the timed shapes as JSON to FILE.

Checks (``chip_smoke``'s tolerances): B6 in bf16 at the ``[lm]``
qwen3-32b prefill layer, at S 4,096, its lse entry at the ``[train]``
layer (o, lse, and the backward run on them), and head widths 13, 16,
32, 64, 96, 100 and 128, causal and full, and Sq != Sk; B5 at
``serve_p99`` (H 39 and 200), at its two edge shapes, and the
input-gradient launches of an H-200 layer at B 512 and 65,536 (dx_k:
H' 200, M' 39, K' 200; dx_0: H' 200, M' 200, K' 39, through
``input_grad_x0``) against float64 on a subset of rows.  ``--quick``
stops after the checks.

Timed (CUDA events, median of 25, and ``torch.profiler`` device time):
the kernel, its plain version and the library call (SDPA;
``einsum`` where its intermediate fits in 16 GB, else "not measured"
with its size), beside the bound: bytes at 3.35 TB/s and operations at
989 TFLOP/s bf16, 67 TFLOP/s f32 or, for B5's 3xTF32, three TF32
products at 495 TFLOP/s.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BF16_PEAK, F32_PEAK, TF32_PEAK, BYTES_PER_S = 989e12, 67e12, 495e12, 3.35e12
EINSUM_LIMIT = 16 * 2 ** 30        # bytes of einsum's z we let it build


def ptxas_lines(text: str) -> list[str]:
    """The compiler's lines on the two forward sources' kernels."""
    out, keep = [], False
    for line in text.splitlines():
        if line.startswith("[nvcc"):
            keep = "flash_attn.cu" in line or "cin.cu" in line
            if keep:
                out.append(line)
            continue
        if keep and re.search(r"Compiling entry|Used|spill|arning", line):
            out.append("  " + line.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", help="JSON file for the timed shapes")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import _build, cin, flash_attn, ref
    import chip_smoke as cs      # after repro_torch: it puts ROOT/src first
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"src {args.src}: {cin.__file__}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sec = _build.build_all(verbose=True)
    print(f"build {sec:.1f} s")
    print("\n".join(ptxas_lines(buf.getvalue())))
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(28)
    failures = []

    def held(name, got, want, what, rtol, atol):
        err = cs.max_abs_err(torch, got.float(), want.float())
        ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
        print(f"  {name} {what}: max_abs_err {err:.3e} (rtol {rtol:g}, "
              f"atol {atol:g}) {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            failures.append(f"{name} {what}")
        return err

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    bf = torch.bfloat16
    tol_bf = cs.ATTN_TOL["bfloat16"]
    # ---- B6 checks --------------------------------------------------------
    attn = {}
    for tag, a, seed in (("[lm] layer", cs.LM_ATTN_SHAPE, 2),
                         ("S 4096", cs.ATTN_SHAPE, 0),
                         ("[train] layer", cs.TRAIN_ATTN_SHAPE, 3)):
        q, k, v = cs.attn_inputs(torch, bf, seed=seed, a=a)
        attn[tag] = (q, k, v)
        what = f"bf16 {tag} B={a['B']} H={a['H']} S={a['S']} causal"
        if tag != "[train] layer":
            held("flash_attention", flash_attn.flash_attention(q, k, v, True),
                 ref.flash_attention_ref(q, k, v, causal=True), what,
                 **tol_bf)
            continue
        o, lse = flash_attn._forward(q, k, v, True, with_lse=True)
        want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, True)
        held("flash_attention_lse", o, want_o, what + " o", **tol_bf)
        held("flash_attention_lse", lse, want_lse, what + " lse",
             **cs.ATTN_TOL["float32"])
        do = randn(*q.shape, dtype=bf)
        grads = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, True)
        wants = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True)
        for gname, got, want in zip(("dq", "dk", "dv"), grads, wants):
            ok, worst, _ = cs.bf16_grad_check(torch, got, want)
            print(f"  flash_attention_bwd on the new o, lse {gname}: worst "
                  f"error / allowance {worst:.3f} {'ok' if ok else 'FAILED'}")
            if not ok:
                failures.append(f"flash_attention_bwd {gname}")
        del o, lse, want_o, want_lse, do, grads, wants
    for d in (13, 16, 32, 64, 96, 100, 128):
        for causal, sk in ((True, 256), (False, 256), (False, 384)):
            q = randn(1, 4, 256 if causal or sk == 256 else 128, d, dtype=bf)
            k, v = randn(1, 4, sk, d, dtype=bf), randn(1, 4, sk, d, dtype=bf)
            what = (f"bf16 d={d} Sq={q.shape[2]} Sk={sk} "
                    f"{'causal' if causal else 'full'}")
            held("flash_attention", flash_attn.flash_attention(q, k, v,
                                                               causal),
                 ref.flash_attention_ref(q, k, v, causal=causal), what,
                 **tol_bf)
            o, lse = flash_attn._forward(q, k, v, causal, with_lse=True)
            _, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal)
            held("flash_attention_lse", lse, want_lse, what + " lse",
                 **cs.ATTN_TOL["float32"])
    # ---- B5 checks --------------------------------------------------------
    cin_cases = {}
    c = cs.CIN_SHAPE
    for H in (c["M"], 200):
        xk, x0 = randn(c["B"], H, c["D"]), randn(c["B"], c["M"], c["D"])
        w = randn(c["K"], H, c["M"])
        what = f"serve B={c['B']} H={H} M={c['M']} D={c['D']} K={c['K']}"
        held("cin_layer", cin.cin_layer(xk, x0, w), ref.cin_layer_ref(
            xk.double(), x0.double(), w.double()).float(), what, 3e-4, 3e-4)
        cin_cases[what] = ("layer", xk, x0, w)
    for B, H, M, D, K in ((37, 7, 5, 3, 65), (1, 200, 39, 10, 200),
                          (3, 7, 1, 4, 39), (300, 221, 221, 2, 9)):
        if M > cin.MAX_FIELDS:
            print(f"  cin_layer edge M={M}: past MAX_FIELDS, not run")
            continue
        xk, x0, w = randn(B, H, D), randn(B, M, D), randn(K, H, M)
        held("cin_layer", cin.cin_layer(xk, x0, w), ref.cin_layer_ref(
            xk.double(), x0.double(), w.double()).float(),
            f"edge B={B} H={H} M={M} D={D} K={K}", 3e-4, 3e-4)
    for B in cs.CIN_TRAIN_BATCHES:
        g, xk, x0 = randn(B, 200, 10), randn(B, 200, 10), randn(B, 39, 10)
        w = randn(200, 200, 39)
        wt = w.permute(1, 0, 2).contiguous()
        rows = torch.cat([torch.arange(0, min(B, 256)),
                          torch.arange(max(0, B - 256), B)]).unique()
        dxk = cin._forward(g, x0, wt)
        dx0 = cin.input_grad_x0(g, xk, w)
        want = ref.cin_layer_bwd_ref(xk[rows].double(), x0[rows].double(),
                                     w.double(), g[rows].double())
        for gname, got, wnt in (("dx_k", dxk, want[0]), ("dx_0", dx0,
                                                           want[1])):
            scale = float(wnt.abs().max())
            held("cin_layer", got[rows], wnt.float(),
                 f"{gname} B={B} rows {len(rows)}, tol 3e-4 x max "
                 f"{scale:.3g}", 0.0, 3e-4 * scale)
        cin_cases[f"dx_k B={B} (H'=200 M'=39 K'=200)"] = ("dxk", g, x0, wt)
        cin_cases[f"dx_0 B={B} (H'=200 M'=200 K'=39)"] = ("dx0", g, xk, w)
        del dxk, dx0, want
    if failures:
        print("FAILED: " + "; ".join(failures))
        return 1
    print("checks: all held")
    if args.quick:
        return 0

    # ---- timing -------------------------------------------------------------
    out = []

    def timed(name, what, kern, plain, lib, lib_name, nbytes, nops, peak,
              tc=None, plain_reps=5):
        ms = cs.time_ms(torch, kern)
        dms = cs.device_ms(torch, kern)
        pl = cs.time_ms(torch, plain, reps=plain_reps, warmup=1)
        pdms = cs.device_ms(torch, plain, reps=plain_reps)
        if lib is None:
            lb = ldms = None
        else:
            lb = cs.time_ms(torch, lib, reps=5, warmup=1)
            ldms = cs.device_ms(torch, lib, reps=5)
        b_bytes, b_ops = nbytes / BYTES_PER_S * 1e3, nops / peak * 1e3
        row = dict(name=name, shape=what, ms=ms, device_ms=dms,
                   plain_ms=pl, plain_device_ms=pdms, library=lib_name,
                   library_ms=lb, library_device_ms=ldms,
                   bound_ms=max(b_bytes, b_ops),
                   bound_by="bytes" if b_bytes >= b_ops else "operations")
        if tc:
            row["tf32x3_bound_ms"] = 3 * nops / tc * 1e3
        out.append(row)
        lib_txt = (f"{lb:.4f} / {ldms:.4f}" if lb is not None else
                   "not measured")
        print(f"  {name} {what}: card {ms:.4f} ms, device {dms:.4f} ms; "
              f"plain {pl:.4f} / {pdms:.4f}; {lib_name} {lib_txt}; bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']})"
              + (f", TF32 x3 {row['tf32x3_bound_ms']:.4f}" if tc else "")
              + f"; {nops / dms / 1e9:.1f} TFLOP/s", flush=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for tag, (q, k, v) in attn.items():
        B, H, S, d = q.shape
        lse_entry = tag == "[train] layer"
        name = "flash_attention_lse" if lse_entry else "flash_attention"
        timed(name, f"bf16 {tag} B={B} H={H} S={S} d={d} causal",
              (lambda q=q, k=k, v=v: flash_attn._forward(q, k, v, True,
                                                         lse_entry)),
              (lambda q=q, k=k, v=v: ref.flash_attention_fwd_ref(q, k, v,
                                                                 True)),
              lambda q=q, k=k, v=v: sdpa(q, k, v, is_causal=True), "sdpa",
              4 * q.numel() * 2 + (4 * B * H * S if lse_entry else 0),
              2.0 * S * S * d * B * H, BF16_PEAK, plain_reps=3)
    del attn
    torch.cuda.empty_cache()
    for what, (kind, a, b, w) in cin_cases.items():
        if kind == "dx0":               # g [B, K, D], x_k, w [K, H, M]
            B, Hp, D = a.shape[0], w.shape[0], a.shape[2]
            Mp, Kp = b.shape[1], w.shape[2]

            def kern(a=a, b=b, w=w):
                return cin.input_grad_x0(a, b, w)
            wp = w.permute(2, 0, 1).contiguous()      # [M, K, H]
            xa, xb, ww = a, b, wp
        else:                           # the layer itself on (a, b, w)
            B, Hp, D = a.shape
            Mp, Kp = b.shape[1], w.shape[0]

            def kern(a=a, b=b, w=w):
                return cin._forward(a, b, w)
            xa, xb, ww = a, b, w
        part = max(1, min(B, 2 ** 31 // (Hp * Mp * D * 4)))

        def plain(xa=xa, xb=xb, ww=ww, part=part):
            return torch.cat([ref.cin_layer_ref(xa[i:i + part],
                                                xb[i:i + part], ww)
                              for i in range(0, xa.shape[0], part)])
        z_bytes = B * Hp * Mp * D * 4
        lib = None
        lib_name = f"einsum (not measured: z {z_bytes / 1e9:.1f} GB)"
        if z_bytes <= EINSUM_LIMIT:
            lib_name = "einsum"

            def lib(xa=xa, xb=xb, ww=ww):
                return torch.einsum("khm,bhd,bmd->bkd", ww, xa, xb)
        nops = 2.0 * Kp * Hp * Mp * D * B
        nbytes = 4 * (B * Hp * D + B * Mp * D + Kp * Hp * Mp + B * Kp * D)
        timed("cin_layer", what, kern, plain, lib, lib_name, nbytes, nops,
              F32_PEAK, tc=TF32_PEAK, plain_reps=3)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=smi.stdout.strip(), src=args.src, rows=out), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
