#!/usr/bin/env python3
"""What bounds B6's backward: ablations of ``csrc/flash_attn_bwd.cu`` on
one CUDA card.

    python3 tools/attn_bwd_ablations.py

Builds copies of the kernel's source into ``build/tools/ablations/``, each
with parts of the work taken out, and times every copy's C entry (CUDA
events, mean of 10 calls after 3, the D pre-pass and the dQ cast
included) on two bf16 causal shapes of the same operations: the [train]
qwen3-32b layer (B 4, H 64, S 1,024, d 128: 4,096 blocks of 64 keys, the
dQ accumulator 134 MB) and B 1, H 16, S 4,096, d 128 (1,024 blocks, 34
MB).  The copies:

- ``kernel``: unchanged (held against the plain version first);
- ``no dQ reduce-add``: dQ's tiles are formed but not added into dqacc;
- ``no dQ``: dQ's product and reduce-add dropped;
- ``no products``: S, dP, dV, dK and dQ dropped (the softmax, the P and
  dS hand-offs and every barrier stay);
- ``tile ring only``: the consumers take each tile and release it;
- ``D pass and dQ cast only``: the main kernel not launched.

Prints the card's name and power limit, then one line a shape and copy.
The ablated copies' results are wrong by design.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

DQ_LOOP = "for (int h = ROLE == 2 ? 1 : 0; h < (ROLE == 1 ? 1 : 2); ++h) {"
REDUCE = """        bulk_reduce_add(
            b.dqacc + ((b.bh * b.n_qt + it) * 2 + h) * (kBq * DMAX / 2),
            qbuf, C::DQ);
        bulk_commit();"""
PRODUCTS = [
    ("        ss<64, 0, 0>(sc, at(k_a, ka), at(q_b, qa), F32 || kk > 0);", ""),
    ("        ss<64, 0, 0>(sc, at(v_a, ka), at(do_b, qa), F32 || kk > 0);",
     ""),
    ("        rs<DMAX>(dva, pa[kk], at(do_t, kk * 2048));", ""),
    ("        rs<DMAX>(dka, sa[kk], at(q_t, kk * 2048));", ""),
    (DQ_LOOP, "for (int h = 0; h < 0; ++h) {"),
]
VARIANTS = {
    "kernel": [],
    "no dQ reduce-add": [(REDUCE, "")],
    "no dQ": [(DQ_LOOP, "for (int h = 0; h < 0; ++h) {")],
    "no products": PRODUCTS,
    "tile ring only": [(
        "    mbar_wait(&b.full[st], (n / STAGES) & 1);\n",
        "    mbar_wait(&b.full[st], (n / STAGES) & 1);\n"
        "    if (n >= 0) {\n      mbar_arrive(&b.empty[st]);\n"
        "      continue;\n    }\n")],
    "D pass and dQ cast only": [(
        "  if (!F32 && d == DMAX && al && aligned16(lse)) {",
        "  if (d > 0) {\n    err = cudaSuccess;\n"
        "  } else if (!F32 && d == DMAX && al && aligned16(lse)) {")],
}


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, flash_attn, ref
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.build_all()
    fns = {name: _build.build_variant(
        "flash_attention_bwd", edits,
        ROOT / "build" / "tools" / "ablations" / name.replace(" ", "_"))
        for name, edits in VARIANTS.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, H, S, d in ((4, 64, 1024, 128), (1, 16, 4096, 128)):
        q, k, v, do = (torch.randn((B, H, S, d), generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = flash_attn._forward(q, k, v, True, with_lse=True)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((B, H, S), device="cuda")
        acc = torch.empty((B, H, S, 128), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for name, f in fns.items():
            def call():
                rc = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                       acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), B * H, S, S, d, 1, 1, stream)
                _build.check(rc, name)
            call()
            torch.cuda.synchronize()
            if name == "kernel":
                wants = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True)
                for got, want in zip((dq, dk, dv), wants):
                    if not cs.bf16_grad_check(torch, got, want)[0]:
                        raise SystemExit("the unchanged kernel disagrees")
            for _ in range(3):
                call()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(10):
                call()
            b.record()
            torch.cuda.synchronize()
            print(f"bf16 B={B} H={H} S={S} d={d} causal, {name}: "
                  f"{a.elapsed_time(b) / 10:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
