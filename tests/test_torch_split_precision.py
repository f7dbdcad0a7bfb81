"""The numeric designs of the port's tensor-core kernels, checked on the CPU.

The CUDA kernels run only on the card, so these tests emulate their
split-f32 arithmetic in PyTorch on the same numpy inputs and hold it to
the card's tolerances against float64:

- ``csrc/cin.cu`` (B5): 3xTF32.  Each operand is split into hi = tf32(x)
  and lo = tf32(x - hi) (TF32 keeps 10 stored mantissa bits: the low 13
  bits of a float32, rounded half away from zero as ``cvt.rna.tf32.f32``
  does), each product is lo.hi + hi.lo + hi.hi, every 8 values of j are
  summed into a fresh float32 fragment, and fragments are added into a
  Kahan float32 pair; the S parts of a split reduction are summed in
  float64.  At FULL's CIN layer-2 widths the emulation must stay within
  the card's check of the kernel (3e-4 against float64, and 1e-4
  absolute), and a bf16 hi/lo split must not (why the kernel takes TF32).
- ``csrc/flash_attn.cu`` (B6) in float32: bf16 hi/lo splits of q, k, v
  and p with three products each, float32 scores and online-softmax state
  over key tiles of 64, within the card's float32 tolerance (2e-3) of
  float64 attention.

The tensor cores' own accumulation is modelled as one float32 rounding
of each 8-term product sum; the card may truncate where this rounds, and
``chip_smoke.py`` holds the kernels themselves.  The emulation lives here,
on no path of the package.  Also here: the CIN wrapper's split plan as a
pure function, and the tile constants the wrapper shares with the kernel.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import cin, flash_attn
from test_torch_graph import _one_torch_thread  # noqa: F401

CSRC = Path(cin.__file__).resolve().parent / "csrc"


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 (ties away from zero), as float32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def split(x: torch.Tensor, rnd) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rnd(x)
    return hi, rnd(x - hi)


def _cin_inputs(B, H, M, D, K, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, D)).astype(np.float32),
            rng.normal(size=(B, M, D)).astype(np.float32),
            rng.normal(size=(K, H, M)).astype(np.float32))


def cin_emulated(xk, x0, w, rnd=tf32, splits=1, chunk=cin.CHUNK):
    """The kernel's arithmetic: out[b, k, d] from x_k, x_0, w (float32)."""
    B, H, D = xk.shape
    M = x0.shape[1]
    K = w.shape[0]
    z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(B, H * M, D)
    wf = w.reshape(K, H * M)
    zh, zl = (t.double() for t in split(z, rnd))
    wh, wl = (t.double() for t in split(wf, rnd))
    n_chunks = math.ceil(H * M / chunk)
    cps = math.ceil(n_chunks / splits)
    total = torch.zeros((B, K, D), dtype=torch.float64)
    for s in range(splits):
        tot = torch.zeros((B, K, D), dtype=torch.float32)
        ncm = torch.zeros_like(tot)
        for j0 in range(s * cps * chunk, min((s + 1) * cps, n_chunks) * chunk,
                        8):
            sl = slice(j0, j0 + 8)
            prods = (torch.einsum("kj,bjd->bkd", wh[:, sl], zl[:, sl])
                     + torch.einsum("kj,bjd->bkd", wl[:, sl], zh[:, sl])
                     + torch.einsum("kj,bjd->bkd", wh[:, sl], zh[:, sl]))
            f = (prods + ncm.double()).float()     # the fresh fragment
            u = tot + f
            ncm = f - (u - tot)
            tot = u
        total += (tot + ncm).double()
    return total.float()


@pytest.mark.parametrize("splits", [1, 5])
@pytest.mark.parametrize("B,H,M,D,K", [(4, 200, 39, 10, 200),
                                       (4, 39, 39, 10, 200)])
def test_cin_3xtf32_emulation_holds_the_card_tolerance(B, H, M, D, K, splits):
    """FULL's CIN layers 2 and 1 (and a reduction split in parts, as at
    B = 512) within 1e-4 of float64, and of the reference's einsum."""
    xk, x0, w = _cin_inputs(B, H, M, D, K, seed=splits)
    exact = np.einsum("khm,bhd,bmd->bkd", w.astype(np.float64),
                      xk.astype(np.float64), x0.astype(np.float64))
    got = cin_emulated(torch.from_numpy(xk), torch.from_numpy(x0),
                       torch.from_numpy(w), splits=splits).numpy()
    err = np.abs(got - exact).max()
    assert err <= 1e-4, err
    np.testing.assert_allclose(got, exact, rtol=3e-4, atol=3e-4)
    want = np.asarray(rref.cin_layer_ref(xk, x0, w))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_cin_bf16_split_would_miss_the_card_tolerance():
    """The same design with bf16 hi/lo (~16 significant bits) strays past
    1e-4 at layer-2 widths: why the kernel splits into TF32."""
    xk, x0, w = _cin_inputs(4, 200, 39, 10, 200, seed=1)
    exact = np.einsum("khm,bhd,bmd->bkd", w.astype(np.float64),
                      xk.astype(np.float64), x0.astype(np.float64))
    tf = cin_emulated(*(torch.from_numpy(a) for a in (xk, x0, w))).numpy()
    bf = cin_emulated(*(torch.from_numpy(a) for a in (xk, x0, w)),
                      rnd=bf16).numpy()
    assert np.abs(bf - exact).max() > 1e-4
    assert np.abs(bf - exact).max() > 10 * np.abs(tf - exact).max()


@pytest.mark.parametrize("x", [1.0, -1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                               -(1.0 + 3 * 2.0 ** -12), 3.14159265])
def test_tf32_rounding_and_split(x):
    """tf32 keeps 11 significant bits, ties away from zero; hi + lo holds
    22 of them."""
    t = torch.tensor([x], dtype=torch.float32)
    hi, lo = split(t, tf32)
    assert float(hi) == pytest.approx(x, rel=2.0 ** -11)
    assert (hi.view(torch.int32) & 0x1FFF).item() == 0
    assert abs(float(hi + lo) - float(t)) <= abs(float(t)) * 2.0 ** -22
    if x == 1.0 + 2.0 ** -11:                     # a tie: away from zero
        assert float(hi) == 1.0 + 2.0 ** -10


def flash_f32_emulated(q, k, v, causal, block=64):
    """The f32 kernel's arithmetic on [BH, S, d] float32 tensors."""
    d = q.shape[-1]
    scale_log2 = float(np.float32(1.0 / math.sqrt(d) * math.log2(math.e)))
    qh, ql = (t.double() for t in split(q, bf16))
    m = torch.full(q.shape[:2], -1e30)
    l = torch.zeros(q.shape[:2])
    acc = torch.zeros(q.shape)
    rows = torch.arange(q.shape[1])[:, None]
    for k0 in range(0, k.shape[1], block):
        kh, kl = (t.double() for t in split(k[:, k0:k0 + block], bf16))
        vh, vl = (t.double() for t in split(v[:, k0:k0 + block], bf16))
        s = (torch.einsum("bqd,bkd->bqk", ql, kh)
             + torch.einsum("bqd,bkd->bqk", qh, kl)
             + torch.einsum("bqd,bkd->bqk", qh, kh)).float()
        if causal:
            s = torch.where(k0 + torch.arange(block)[None] > rows,
                            -math.inf, s)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        ph, pl = (t.double() for t in split(p, bf16))
        pv = (torch.einsum("bqk,bkd->bqd", pl, vh)
              + torch.einsum("bqk,bkd->bqd", ph, vl)
              + torch.einsum("bqk,bkd->bqd", ph, vh)).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
    return acc / l.clamp(min=1e-30)[..., None]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_split_bf16_emulation_holds_the_card_tolerance(causal):
    """f32 attention at S = 512, d = 128 on 2 heads: within the card's
    2e-3 of float64, and of the reference's oracle."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 512, 128)).astype(np.float32)
               for _ in range(3))
    got = flash_f32_emulated(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal).numpy()
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(128)
    if causal:
        s = np.where(np.tril(np.ones((512, 512), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    exact = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True),
                      v.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=2e-3, atol=2e-3)
    assert np.abs(got - exact).max() < 1e-4
    want = np.asarray(rref.flash_attention_ref(q[None], k[None], v[None],
                                               causal=causal))[0]
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,H,M,D,K,splits", [
    (512, 200, 39, 10, 200, 5),        # serve_p99, CIN layers 2 and 3
    (512, 39, 39, 10, 200, 5),         # serve_p99, CIN layer 1
    (262144, 200, 39, 10, 200, 1),     # serve_bulk: tiles fill the card
    (4096, 200, 39, 10, 200, 1),
    (1, 200, 39, 10, 200, 25),
    (37, 7, 5, 3, 65, 2),
    (3, 2, 1, 1, 1, 1),
])
def test_cin_plan(B, H, M, D, K, splits):
    p = cin.plan(B, H, M, D, K)
    n_chunks = math.ceil(H * M / cin.CHUNK)
    assert p.splits == splits
    assert (p.splits - 1) * p.chunks_per_split < n_chunks
    assert n_chunks <= p.splits * p.chunks_per_split
    assert p.w_prep_shape == (math.ceil(K / cin.ROWS) * cin.ROWS,
                              n_chunks * 2 * cin.CHUNK)
    assert p.partial_shape == ((splits, K, B * D) if splits > 1 else None)


@pytest.mark.parametrize("B", [1, 64, 512, 2048, 8192, 65536])
def test_cin_plan_fills_waves_without_idle_parts(B):
    """Every part has chunks, and the grid covers at least the waves that
    S = 1 takes, at no more cost in chunk-waves."""
    H, M, D, K, sms = 200, 39, 10, 200, cin.SMS
    p = cin.plan(B, H, M, D, K, sms)
    n_chunks = math.ceil(H * M / cin.CHUNK)
    tiles = math.ceil(B * D / cin.COLS) * math.ceil(K / cin.ROWS)

    def cost(s):
        return math.ceil(tiles * s / sms) * math.ceil(n_chunks / s)
    best = min(cost(s) for s in range(1, n_chunks + 1)
               if s <= math.ceil(4 * sms / tiles))
    assert cost(p.splits) == best <= cost(1)
    if tiles >= 4 * sms:
        assert p.splits == 1 and p.partial_shape is None


def _constexprs(source: str) -> dict[str, int]:
    """``constexpr int`` values of a CUDA source, evaluated in order."""
    vals: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", source):
        try:                        # template-dependent ones are skipped
            vals[name] = int(eval(expr, {"__builtins__": {}}, dict(vals)))
        except (NameError, SyntaxError):
            pass
    return vals


def test_cin_wrapper_constants_match_the_kernel():
    c = _constexprs((CSRC / "cin.cu").read_text())
    assert (cin.COLS, cin.ROWS, cin.CHUNK) == (c["kNc"], c["kKt"], c["kJc"])

    def smem(m):                    # x_0, two stages of 2 x_k rows, W, j table
        return (m + 4) * c["kXs"] * 4 + 2 * c["kWTile"] * 4 + 2 * c["kJc"] * 8
    assert smem(cin.MAX_FIELDS) <= c["kMaxSmem"] < smem(cin.MAX_FIELDS + 1)


def test_flash_wrapper_block_covers_the_kernel_tiles():
    c = _constexprs((CSRC / "flash_attn.cu").read_text())
    assert flash_attn.BLOCK % c["kBk"] == 0
    assert flash_attn.BLOCK % (16 * 8) == 0       # 8 warps of 16 rows (f32)
