"""Masked global min wrappers (port of ``repro/kernels/segment_min.py``, B4).

``masked_min`` is the counterpart at the TPU kernel's signature, batched
over lanes.  ``masked_min_pair`` is what the pallas round runs: its minD
and out-rule threshold over one mask in one launch, ``[B, 2]``, left on
the device (no host read).  A CPU tensor goes to the plain versions in
``ref.py``, a CUDA tensor to ``csrc/segment_min.cu``; anything else
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Blocks a lane at most (1 per 4,096 elements below that); sizes the
# scratch of the kernel's cross-block min.
MAX_BLOCKS = 512

# (device index, stream handle) -> (partials, tickets).  The kernel's last
# block of a lane sets the lane's ticket back to 0, so one scratch serves
# every call in order on its stream; calls on two streams may overlap, so
# each stream has its own.  A larger batch replaces it, on the same
# stream, so the allocator reuses the old one only after the calls that
# read it.
_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _check(x: torch.Tensor, mask: torch.Tensor,
           add: torch.Tensor | None) -> None:
    dev = x.device
    # one pass for the tensors a call takes; the checks below name a fault
    if (x.dtype is torch.float32 and mask.dtype is torch.bool
            and x.dim() == 2 and mask.shape == x.shape
            and mask.device == dev and x.is_contiguous()
            and mask.is_contiguous()
            and (add is None or (add.dtype is torch.float32
                                 and add.dim() == 1
                                 and add.shape[0] == x.shape[1]
                                 and add.device == dev
                                 and add.is_contiguous()))):
        return
    if x.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"x must be float32 and mask bool, got {x.dtype} "
                        f"and {mask.dtype}")
    if x.dim() != 2 or mask.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and mask {tuple(mask.shape)} "
                         "must both be [B, n]")
    if mask.device != dev:
        raise ValueError(f"mask on {mask.device}, x on {dev}")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("x and mask must be contiguous")
    if add.dtype != torch.float32:
        raise TypeError(f"add must be float32, got {add.dtype}")
    if add.shape != x.shape[1:] or add.device != dev:
        raise ValueError(f"add {tuple(add.shape)} on {add.device} must be "
                         f"[{x.shape[1]}] on {dev}")
    raise ValueError("add must be contiguous")


def _launch(name: str, x: torch.Tensor, ptrs: tuple,
            out: torch.Tensor) -> torch.Tensor:
    """Launch ``name`` on ``x``'s device and current stream with the
    scratch of that stream; ``ptrs`` are the inputs' data pointers."""
    dev = x.device
    B, n = x.shape
    stream = _build.raw_stream(dev)
    scratch = _scratch.get((dev.index, stream))
    if scratch is None or scratch[1].shape[0] < B:
        scratch = _scratch[(dev.index, stream)] = (
            torch.empty(B * MAX_BLOCKS * 2, dtype=torch.float32, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev))
    rc = _build.function(name)(*ptrs, scratch[0].data_ptr(),
                               scratch[1].data_ptr(), out.data_ptr(), B, n,
                               MAX_BLOCKS, dev.index, stream)
    _build.check(rc, name)
    _build.count_launch(name)
    return out


def masked_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """float32[B, n] x, bool[B, n] mask -> float32[B] (+inf if empty)."""
    _check(x, mask, None)
    dev = x.device
    if dev.type == "cpu":
        return ref.masked_min_ref(x, mask)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty((x.shape[0],), dtype=torch.float32, device=dev)
    return _launch("masked_min", x, (x.data_ptr(), mask.data_ptr()), out)


def masked_min_pair(x: torch.Tensor, mask: torch.Tensor,
                    add: torch.Tensor | None) -> torch.Tensor:
    """float32[B, n] x, bool[B, n] mask, float32[n] add or None ->
    float32[B, 2]: the min of ``x`` and the min of ``x + add`` over each
    lane's mask (+inf if the lane's mask is empty, column 1 +inf if
    ``add`` is None).  The CUDA kernel takes no NaN."""
    _check(x, mask, add)
    dev = x.device
    if dev.type == "cpu":
        return ref.masked_min_pair_ref(x, mask, add)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty((x.shape[0], 2), dtype=torch.float32, device=dev)
    return _launch("masked_min_pair", x, (
        x.data_ptr(), mask.data_ptr(),
        None if add is None else add.data_ptr()), out)
