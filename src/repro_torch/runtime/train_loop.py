"""Training runtime (port of ``repro/runtime/train_loop.py``): a step with
gradient accumulation, global-norm clipping, the warmup-cosine schedule
and AdamW; ``Trainer`` with metrics, checkpoints, resume and a watchdog.

Differences from the reference:

  * PyTorch runs eagerly: ``make_train_step`` returns a plain function.
    Its microbatches run one after another in a Python loop (the
    reference's ``lax.scan``), each taking its gradients with
    ``torch.autograd.grad`` and freeing its graph before the next.
  * ``donate`` and the shardings have no counterpart: ``adamw_update``
    writes parameters and moments in place, and one device holds them.
  * The parameters' leaves are set to require grad by the step (a tree
    from ``init_params``, ``convert`` or a checkpoint need not be).
  * Batches from ``next_batch`` (numpy) go to the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.store import tree_leaves, tree_unflatten
from repro_torch.distributed.fault import StepTimer, StepWatchdog
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               warmup_cosine)
from repro_torch.optim.adamw import host_scalars


@dataclasses.dataclass
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    grad_accum: int = 1
    clip_norm: float = 1.0
    weight_decay: float = 0.01
    ckpt_every: int = 200
    ckpt_dir: str | None = None
    ckpt_keep: int = 3
    watchdog_s: float = 600.0


def _grads(loss_fn, params, leaves, batch):
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(loss_fn: Callable, tcfg: TrainConfig):
    """``loss_fn(params, microbatch) -> (loss, metrics dict)``.

    Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the leading dim of every batch tensor is split into
    ``grad_accum`` microbatches, whose gradients are summed in float32 and
    divided by their count (the metrics are the last microbatch's).  A
    batch whose leading dim is not a multiple of ``grad_accum`` raises
    ``ValueError``, as the reference's reshape into microbatches does."""

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        accum = tcfg.grad_accum
        if accum > 1:
            for k, v in batch.items():
                if v.shape[0] % accum:
                    raise ValueError(
                        f"batch[{k!r}] has {v.shape[0]} rows, not a "
                        f"multiple of grad_accum={accum}")
            gsum = lsum = None
            for i in range(accum):
                mb = {k: v[i * (v.shape[0] // accum):
                           (i + 1) * (v.shape[0] // accum)]
                      for k, v in batch.items()}
                loss, metrics, grads = _grads(loss_fn, params, leaves, mb)
                grads = [g.float() for g in grads]
                gsum = grads if gsum is None else [
                    a + g for a, g in zip(gsum, grads)]
                lsum = loss if lsum is None else lsum + loss
                del grads
            grads = [g / accum for g in gsum]
            loss = lsum / accum
        else:
            loss, metrics, grads = _grads(loss_fn, params, leaves, batch)
        grads, gnorm = clip_by_global_norm(tree_unflatten(params, grads),
                                           tcfg.clip_norm)
        with host_scalars():
            lr = warmup_cosine(opt_state["step"], peak_lr=tcfg.peak_lr,
                               warmup=tcfg.warmup, total=tcfg.total_steps)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                         weight_decay=tcfg.weight_decay)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return step


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v.to(device)
            for k, v in batch.items()}


class Trainer:
    """End-to-end loop: data -> step -> metrics/checkpoints, with resume.
    Batches go to the device of the parameters' first leaf; ``name`` is
    the reference's label of a run and is not used."""

    def __init__(self, loss_fn, params, tcfg: TrainConfig,
                 next_batch: Callable[[], dict], name: str = "run"):
        self.tcfg = tcfg
        self.params = params
        self.opt_state = adamw_init(params)
        self.step_fn = make_train_step(loss_fn, tcfg)
        self.next_batch = next_batch
        self.device = tree_leaves(params)[0].device
        self.mgr = (CheckpointManager(tcfg.ckpt_dir, tcfg.ckpt_keep)
                    if tcfg.ckpt_dir else None)
        self.timer = StepTimer()
        self.history: list[dict] = []
        self.start_step = 0

    def maybe_resume(self) -> int:
        """Load the newest checkpoint if there is one; its step (else 0)."""
        if not self.mgr:
            return 0
        state_like = {"params": self.params, "opt": self.opt_state}
        step, tree = self.mgr.restore_latest(state_like)
        if step is not None:
            self.params = tree["params"]
            self.opt_state = tree["opt"]
            self.start_step = step
            return step
        return 0

    def run(self, n_steps: int, log_every: int = 20,
            print_fn=print) -> list[dict]:
        for i in range(self.start_step, self.start_step + n_steps):
            batch = _to_device(self.next_batch(), self.device)
            self.timer.start()
            with StepWatchdog(self.tcfg.watchdog_s):
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
            self.timer.stop()
            metrics["step"] = i + 1
            metrics["step_time_s"] = self.timer.times[-1]
            self.history.append(metrics)
            if (i + 1) % log_every == 0 and print_fn:
                print_fn(
                    f"step {i+1:5d} loss {metrics['loss']:.4f} "
                    f"lr {metrics['lr']:.2e} "
                    f"gnorm {metrics['grad_norm']:.2f} "
                    f"{metrics['step_time_s']*1e3:.0f} ms")
            if self.mgr and (i + 1) % self.tcfg.ckpt_every == 0:
                self.mgr.save(
                    i + 1, {"params": self.params, "opt": self.opt_state})
        if self.mgr:
            self.mgr.wait()
        return self.history
