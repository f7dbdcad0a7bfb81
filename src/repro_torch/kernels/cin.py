"""xDeepFM CIN layer wrapper (port of ``repro/kernels/cin.py``, B5).

``out[b, k, d] = sum_{h, m} w[k, h, m] * x_k[b, h, d] * x_0[b, m, d]``
without building ``z[b, h, m, d]``.  A CPU tensor goes to
``ref.cin_layer_ref``, a CUDA tensor to ``csrc/cin.cu``, which takes any
batch size (the reference padded B to its TPU block of 32).

Scoring only: the reference kernel has no backward, and neither has
this one, so an input that requires grad (with grad mode on) raises
rather than returning a result with no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# fields the kernel's dynamic shared memory holds: 64 KiB of f64 totals
# and (128 + 65) * 4 bytes a field, at most 232,448 bytes a block on an
# H100
MAX_FIELDS = 216


def cin_layer(x_k: torch.Tensor, x_0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """float32 x_k [B, H, D], x_0 [B, M, D], w [K, H, M] -> [B, K, D]."""
    for name, t in (("x_k", x_k), ("x_0", x_0), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-d, got {tuple(t.shape)}")
        if t.device != x_k.device:
            raise ValueError(f"{name} on {t.device}, x_k on {x_k.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, D = x_k.shape
    M = x_0.shape[1]
    K = w.shape[0]
    if x_0.shape != (B, M, D) or w.shape != (K, H, M):
        raise ValueError(f"x_k {tuple(x_k.shape)}, x_0 {tuple(x_0.shape)} "
                         f"and w {tuple(w.shape)} must be [B, H, D], "
                         "[B, M, D] and [K, H, M]")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x_k, x_0, w)):
        raise RuntimeError("cin_layer has no backward kernel: score under "
                           "torch.no_grad() or with inputs that do not "
                           "require grad")
    if x_k.device.type == "cpu":
        return ref.cin_layer_ref(x_k, x_0, w)
    if x_k.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_k.device}")
    if M > MAX_FIELDS:
        raise ValueError(f"M = {M} fields exceed the kernel's shared "
                         f"memory ({MAX_FIELDS} at most)")
    out = torch.empty((B, K, D), dtype=torch.float32, device=x_k.device)
    fn = _build.function("cin_layer")
    with torch.cuda.device(x_k.device):
        stream = torch.cuda.current_stream(x_k.device).cuda_stream
        rc = fn(x_k.data_ptr(), x_0.data_ptr(), w.data_ptr(), out.data_ptr(),
                B, H, M, D, K, stream)
    _build.check(rc, "cin_layer")
    _build.count_launch("cin_layer")
    return out
