"""LM serving launcher: batched decode against a KV cache (port of
``repro/launch/serve.py``, the same flags plus ``--device``).

  python -m repro_torch.launch.serve --arch qwen3-32b             # card
  python -m repro_torch.launch.serve --arch qwen3-32b --device cpu

Serves the arch's smoke config with random weights (generator seed 0)
and ``--batch`` random prompts of ``--prompt-len`` tokens (numpy seed
0) through ``BatchServer`` on ``--device`` (default ``cuda``), and
prints the tokens a second.  ``main(argv)`` returns the exit code.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.graph import resolve_device
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import BatchServer, Request

    cfg = get_arch(args.arch).smoke
    device = resolve_device(args.device)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                        args.prompt_len).tolist(),
                    max_new=args.max_new)
            for _ in range(args.batch)]
    server = BatchServer(params, cfg, batch=args.batch,
                         max_seq=args.prompt_len + args.max_new + 8,
                         temperature=args.temperature, device=device)
    t0 = time.perf_counter()
    server.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out) for r in reqs)
    print(f"generated {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s batched) on {device}")
    for i, r in enumerate(reqs[:2]):
        print(f"req{i}: {r.out[:16]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
