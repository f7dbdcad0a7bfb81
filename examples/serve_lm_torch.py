"""Serve a small LM with batched requests on the PyTorch/CUDA port: one
batched prefill (B6, one launch a layer) into a KV cache, then decode
steps.

  python examples/serve_lm_torch.py --batch 4 --max-new 24
  python examples/serve_lm_torch.py --ci          # 2 requests, 8 tokens
  python examples/serve_lm_torch.py --device cpu

Runs on CUDA unless ``--device`` names another device.  ``main(argv)``
returns the exit code.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: the reference example's model: 4 layers, d 128, 8/2 heads, f32
CONFIG = dict(name="serve-demo", n_layers=4, d_model=128, n_heads=8,
              n_kv_heads=2, d_ff=512, vocab=512, param_dtype="float32",
              remat=False, max_seq=256)


def model(device):
    """``(cfg, params)``: ``CONFIG`` with random weights from seed 0."""
    import torch

    from repro_torch.models.transformer import LMConfig, init_params
    cfg = LMConfig(**CONFIG)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(cfg, gen, device)


def requests(mod, vocab: int, batch: int, prompt_len: int, max_new: int):
    """``batch`` requests of ``mod.Request`` (the port's or the
    reference's) with seed-0 prompts."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [mod.Request(prompt=[int(t) for t in
                                rng.integers(0, vocab, prompt_len)],
                        max_new=max_new)
            for _ in range(batch)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None,
                    help="requests (default 4, --ci 2)")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=None,
                    help="tokens a request (default 24, --ci 8)")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--ci", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.graph import resolve_device
    from repro_torch.runtime import serve_loop
    from repro_torch.runtime.serve_loop import BatchServer

    device = resolve_device(args.device)
    batch = args.batch or (2 if args.ci else 4)
    max_new = args.max_new or (8 if args.ci else 24)
    cfg, params = model(device)
    reqs = requests(serve_loop, cfg.vocab, batch, args.prompt_len, max_new)
    server = BatchServer(params, cfg, batch=batch,
                         max_seq=args.prompt_len + max_new + 8,
                         temperature=args.temperature, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    server.generate(reqs)
    sync()
    dt = time.perf_counter() - t0
    tot = sum(len(r.out) for r in reqs)
    if tot != batch * max_new or not all(
            0 <= t < cfg.vocab for r in reqs for t in r.out):
        raise AssertionError(f"{tot} tokens for {batch} x {max_new}")
    print(f"{tot} tokens in {dt:.2f}s = {tot / dt:.1f} tok/s "
          f"(batch {batch}, {device})")
    for i, r in enumerate(reqs):
        print(f"  req{i}: prompt={r.prompt[:6]}... -> {r.out[:10]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
