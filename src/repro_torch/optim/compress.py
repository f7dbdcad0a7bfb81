"""Int8 gradient compression with error feedback (port of
``repro/optim/compress.py``; Karimireddy et al. 2019).

Gradients are quantized to int8 with a per-tensor scale before a
data-parallel all-reduce, and the quantization error is carried into
the next step.  ``CompressedAllReduce`` reduces over a
``torch.distributed`` group: the max of the ranks' scales (a shared scale
keeps the sum exact in the quantized domain), then the int32 sum of the
values requantized to it.  With no group (``group=None`` and no default
group initialized) it is a world of one, as the distributed SSSP
backend's combine is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import map_leaves


def compress_int8(x: torch.Tensor):
    """``(int8 values, float32 scale)``: symmetric per-tensor quantization."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class CompressedAllReduce:
    """Error-feedback int8 mean over the ranks of ``group``:

        car = CompressedAllReduce(group)
        g_mean, new_err = car(g_local, err)
    """

    def __init__(self, group=None):
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)

    def __call__(self, grad: torch.Tensor, err: torch.Tensor):
        corrected = grad.float() + err
        q, scale = compress_int8(corrected)
        new_err = corrected - decompress_int8(q, scale)
        scale_max = scale.clone()
        if self.group is not None:
            dist.all_reduce(scale_max, dist.ReduceOp.MAX, group=self.group)
        total = torch.round(corrected / scale_max).to(torch.int32)
        if self.group is not None:
            dist.all_reduce(total, dist.ReduceOp.SUM, group=self.group)
        n = torch.tensor(float(self.world), dtype=torch.float32,
                         device=total.device)
        mean = total.float() * scale_max / n
        return mean.to(grad.dtype), new_err


def compress_tree(grads):
    """Every leaf as its ``(int8 values, scale)`` pair."""
    return map_leaves(compress_int8, grads)


def roundtrip_error(x: torch.Tensor) -> torch.Tensor:
    """max |decompress(compress(x)) - x|."""
    q, s = compress_int8(x)
    return (decompress_int8(q, s) - x.float()).abs().max()
