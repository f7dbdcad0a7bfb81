"""Training launcher (port of ``repro/launch/train.py``, the same flags
plus ``--device``):

  python -m repro_torch.launch.train --arch qwen3-32b             # card
  python -m repro_torch.launch.train --arch xdeepfm --device cpu \\
      --ckpt-dir /tmp/ck --resume auto

Trains the arch's smoke config (``--full``: its full config) from random
weights (generator seed 0) on seeded synthetic data through ``Trainer``
on ``--device`` (default ``cuda``): data -> loss -> AdamW -> checkpoints,
with ``--resume auto`` restarting from the newest checkpoint.  LM archs
train on ``TokenStream``, ``xdeepfm`` on ``RecsysStream``.  Every GNN
arch (``gat-cora``, ``pna``, ``dimenet``, ``nequip``) trains what the
reference's launcher trains for it: a ``GATConfig(in_dim=64,
n_classes=7)`` on one ``cora_like(400, 1600, 64)`` graph, whatever the
arch and ``--full``.  ``main(argv)`` returns the exit code.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=["auto", "none"], default="none")
    ap.add_argument("--full", action="store_true",
                    help="use the full config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.core.graph import resolve_device
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    models = [a for a in list_archs() if get_arch(a).kind != "sssp"]
    if args.arch not in models:
        raise SystemExit(
            f"--arch {args.arch}: not a model arch of the port "
            f"({', '.join(models)}); the SSSP engine runs through "
            "repro_torch.sssp")
    spec = get_arch(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    cfg = spec.full if args.full else spec.smoke
    tcfg = TrainConfig(peak_lr=args.lr, warmup=max(args.steps // 10, 5),
                       total_steps=args.steps, grad_accum=args.grad_accum,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)

    if spec.kind == "lm":
        from repro_torch.data.synthetic import TokenStream
        from repro_torch.models import transformer as tfm
        params = tfm.init_params(cfg, gen, device)
        stream = TokenStream(cfg.vocab, args.seq, args.batch)
        trainer = Trainer(lambda p, b: tfm.loss_fn(p, b, cfg), params,
                          tcfg, stream.next_batch, name=args.arch)
    elif spec.kind == "recsys":
        from repro_torch.data.synthetic import RecsysStream
        from repro_torch.models import xdeepfm as xd
        params = xd.init_params(cfg, gen, device)
        stream = RecsysStream(cfg.sizes(), cfg.offsets, args.batch)
        trainer = Trainer(xd.loss_fn, params, tcfg, stream.next_batch,
                          name=args.arch)
    else:                                   # gnn: the reference's GAT run
        from repro_torch.data.synthetic import cora_like
        from repro_torch.models.gnn import gat
        from repro_torch.models.gnn import layers as L
        n, src, dst, x, y = cora_like(n=400, e=1600, d=64)
        batch = L.build_batch(n, src, dst, x, y, device=device)
        gcfg = gat.GATConfig(in_dim=64, n_classes=7)
        params = gat.init_params(gcfg, gen, device)
        trainer = Trainer(lambda p, b: gat.loss_fn(p, batch, gcfg), params,
                          tcfg, lambda: {"_": np.zeros(1)}, name=args.arch)

    if args.resume == "auto":
        step = trainer.maybe_resume()
        print(f"resumed from step {step}")
    trainer.run(args.steps)
    print(f"done on {device}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
