"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-param
qwen3-style LM on the synthetic token task with the full production
substrate: AdamW + clipping + cosine schedule, grad accumulation, async
checkpoints, resume, metrics.  Every step runs B6's forward with the
log-sum-exp and its backward kernel, one each a layer.

  python examples/train_lm_torch.py                 # ~100M params, 300 steps
  python examples/train_lm_torch.py --preset tiny   # CI-scale sanity run
  python examples/train_lm_torch.py --resume auto   # restart from checkpoint
  python examples/train_lm_torch.py --ci --device cpu   # tiny, 6 steps

Runs on CUDA unless ``--device`` names another device.  Checkpoints go
to ``--ckpt-dir`` (default: ``repro_train_lm_torch`` in the temporary
directory).  ``main(argv)`` returns the exit code.
"""
import argparse
import math
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: the reference example's presets: (LMConfig fields, steps, batch, seq,
#: peak lr)
PRESETS = {
    "100m": (dict(name="qwen3-100m", n_layers=12, d_model=768, n_heads=12,
                  n_kv_heads=4, d_ff=3072, vocab=16384, head_dim=64,
                  qk_norm=True, param_dtype="float32", remat=False,
                  max_seq=512), 300, 8, 256, 6e-4),
    "tiny": (dict(name="qwen3-tiny", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab=256, qk_norm=True,
                  param_dtype="float32", remat=False, max_seq=128),
             60, 8, 64, 3e-3),
}


def train_config(mod, steps: int, lr: float, ckpt_dir, ckpt_every: int):
    """The example's ``TrainConfig`` (of ``mod``: the port's or the
    reference's train loop)."""
    return mod.TrainConfig(peak_lr=lr, warmup=max(steps // 10, 5),
                           total_steps=steps, grad_accum=2,
                           ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default=None,
                    help="default 100m, --ci tiny")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm_torch"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", choices=["auto", "none"], default="none")
    ap.add_argument("--ci", action="store_true",
                    help="the tiny preset for 6 steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.store import tree_leaves
    from repro_torch.core.graph import resolve_device
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.transformer import LMConfig, init_params, loss_fn
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.train_loop import Trainer

    device = resolve_device(args.device)
    fields, steps, batch, seq, lr = PRESETS[
        args.preset or ("tiny" if args.ci else "100m")]
    steps = args.steps or (6 if args.ci else steps)
    cfg = LMConfig(**fields)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{steps} steps @ batch {batch} x seq {seq} on {device}")

    stream = TokenStream(cfg.vocab, seq, batch, seed=0)
    trainer = Trainer(lambda p, b: loss_fn(p, b, cfg), params,
                      train_config(train_loop, steps, lr, args.ckpt_dir,
                                   args.ckpt_every),
                      stream.next_batch, name=cfg.name)
    if args.resume == "auto":
        at = trainer.maybe_resume()
        print(f"resumed at step {at}")
    hist = trainer.run(steps, log_every=20)
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    k = min(5, len(hist))
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"\nloss: {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first - 0.3 else 'check settings'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
