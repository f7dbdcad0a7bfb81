"""The numeric designs of the port's tensor-core kernels, checked on the CPU.

The CUDA kernels run only on the card, so these tests emulate their
split-f32 arithmetic in PyTorch on the same numpy inputs and hold it to
the card's tolerances against float64:

- ``csrc/cin.cu`` (B5): 3xTF32.  Each operand is split into hi = tf32(x)
  and lo = tf32(x - hi) (TF32 keeps 10 stored mantissa bits: the low 13
  bits of a float32, rounded half away from zero as ``cvt.rna.tf32.f32``
  does), each product is lo.hi + hi.lo + hi.hi, added into a float32
  accumulator k-step by k-step (8 values of j), which goes into a Kahan
  float32 pair every ``FLUSH`` k-steps; the S parts of a split reduction
  are summed in float64.  At FULL's CIN layer-2 widths the emulation must
  stay within the card's check of the kernel (3e-4 against float64, and
  1e-4 absolute), also at the lengths of j of the ``[train]`` input
  gradients, and a bf16 hi/lo split must not (why the kernel takes TF32).
- ``csrc/flash_attn.cu`` (B6) in float32: bf16 hi/lo splits of q, k, v
  and p with three products each, float32 scores and online-softmax state
  over key tiles of 64, within the card's float32 tolerance (2e-3) of
  float64 attention.
- ``csrc/cin.cu``'s ``cin_weight_grad``: 3xTF32 products of Z = x_k x_0
  and g over k-steps of 8 columns, taken in a float32 accumulator that is
  flushed into a Kahan pair every F k-steps, the S parts added in float64,
  within 3e-4 of the largest magnitude of float64 at the full reduction
  length of B = 65,536 samples.
- ``csrc/flash_attn_bwd.cu`` in float32: bf16 hi/lo splits of every
  product's operands (q, k, v, dO, and P and dS), dK and dV summed in
  float32 over query tiles of 64, dQ over key blocks of 64, within the
  card's 2e-3 of float64 gradients.

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


def cin_emulated(xk, x0, w, rnd=tf32, splits=1, chunk=cin.CHUNK,
                 flush=cin.FLUSH):
    """The kernel's arithmetic: out[b, k, d] from x_k, x_0, w (float32).

    j = h * M + m runs in stages of ``chunk`` values (zero-padded at its
    end) split into S parts of ceil(stages / S) stages; within a part each
    k-step of 8 values of j adds its three products (lo.hi, hi.lo, hi.hi,
    each an exact 8-term sum) into a float32 accumulator, rounding after
    each, and every ``flush`` k-steps (and at the end of the part) the
    accumulator goes into a Kahan float32 pair and keeps the compensation;
    the parts are added in float64."""
    B, H, D = xk.shape
    M = x0.shape[1]
    K = w.shape[0]
    z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(B, H * M, D)
    z = z.permute(0, 2, 1).reshape(B * D, H * M)       # [c, j]
    wf = w.reshape(K, H * M)
    pad = -(H * M) % chunk
    z = torch.cat([z, torch.zeros(B * D, pad)], 1)
    wf = torch.cat([wf, torch.zeros(K, pad)], 1)
    steps = z.shape[1] // 8

    def prod(a, b):                    # [steps, B * D, K] float64
        return torch.einsum("csj,ksj->sck",
                            a.double().reshape(B * D, steps, 8),
                            b.double().reshape(K, steps, 8)).numpy()
    zh, zl = split(z, rnd)
    wh, wl = split(wf, rnd)
    terms = (prod(zl, wh), prod(zh, wl), prod(zh, wh))
    per_stage = chunk // 8
    n_stages = steps // per_stage
    cps = math.ceil(n_stages / splits)
    total = np.zeros((B * D, K))
    f32 = np.float32
    for s in range(splits):
        lo, hi = s * cps * per_stage, min((s + 1) * cps, n_stages) * per_stage
        tot = np.zeros((B * D, K), f32)
        acc = np.zeros_like(tot)
        for i in range(lo, hi):
            for t in terms:
                acc = (acc + t[i]).astype(f32)
            if (i - lo + 1) % flush == 0 or i == hi - 1:
                u = (tot + acc).astype(f32)
                acc = (acc - (u - tot).astype(f32)).astype(f32)
                tot = u
        total += tot.astype(np.float64) + acc.astype(np.float64)
    return torch.from_numpy(total.reshape(B, D, K).transpose(0, 2, 1)
                            .astype(np.float32).copy())


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


@pytest.mark.parametrize("splits", [1, 5])
@pytest.mark.parametrize("H,M,K", [(200, 39, 200), (200, 200, 39)])
def test_cin_forward_emulation_holds_the_card_tolerance_at_train_lengths(
        H, M, K, splits):
    """The forward's sums at the lengths of j the ``[train]`` batch gives
    it: a layer and dx_k (H * M = 7,800, 244 stages) and dx_0 of an H-200
    layer (200 x 200 = 40,000, 1,250 stages), in one part and in five,
    within the card's 3e-4 of float64 (as chip_smoke holds the kernel)."""
    xk, x0, w = _cin_inputs(4, H, M, 10, K, seed=7 + splits)
    exact = np.einsum("khm,bhd,bmd->bkd", w.astype(np.float64),
                      xk.astype(np.float64), x0.astype(np.float64))
    got = cin_emulated(torch.from_numpy(xk), torch.from_numpy(x0),
                       torch.from_numpy(w), splits=splits).numpy()
    np.testing.assert_allclose(got, exact, rtol=3e-4, atol=3e-4)
    assert np.abs(got - exact).max() <= 3e-4 * np.abs(exact).max()


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
    (512, 200, 39, 10, 200, 3),        # serve_p99, CIN layers 2 and 3
    (512, 39, 39, 10, 200, 3),         # serve_p99, CIN layer 1
    (262144, 200, 39, 10, 200, 1),     # serve_bulk: tiles fill the card
    (4096, 200, 39, 10, 200, 1),
    (1, 200, 39, 10, 200, 61),
    (37, 7, 5, 3, 65, 2),
    (3, 2, 1, 1, 1, 1),
    (512, 200, 200, 10, 39, 13),       # dx_0 of an H-200 layer: N = 40
])
def test_cin_plan(B, H, M, D, K, splits):
    p = cin.plan(B, H, M, D, K)
    n_chunks = math.ceil(H * M / cin.CHUNK)
    assert p.splits == splits
    assert (p.splits - 1) * p.chunks_per_split < n_chunks
    assert n_chunks <= p.splits * p.chunks_per_split
    rows = cin.ROWS_SMALL if K <= cin.ROWS_SMALL else cin.ROWS
    assert cin.rows(K) == rows
    assert p.w_prep_shape == (math.ceil(K / rows), n_chunks,
                              2 * rows * cin.CHUNK)
    assert p.partial_shape == ((splits, K, B * D) if splits > 1 else None)


@pytest.mark.parametrize("B", [1, 64, 512, 2048, 8192, 65536])
def test_cin_plan_fills_waves_without_idle_parts(B):
    """Every part has chunks, and the grid covers at least the waves that
    S = 1 takes, at no more cost in chunk-waves."""
    H, M, D, K, sms = 200, 39, 10, 200, cin.SMS
    p = cin.plan(B, H, M, D, K, sms)
    n_chunks = math.ceil(H * M / cin.CHUNK)
    tiles = math.ceil(B * D / cin.COLS) * math.ceil(K / cin.rows(K))

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
    """The forward's tiles, flush period and field limit are the kernel's:
    MAX_FIELDS columns of x_0 (512 bytes each) fit beside two stages at
    N = 104 (Z^T and W^T, hi and lo) and their barriers, one more does
    not."""
    c = _constexprs((CSRC / "cin.cu").read_text())
    assert (cin.COLS, cin.ROWS, cin.ROWS_SMALL, cin.CHUNK) == (
        c["kFCols"], c["kFRowsL"], c["kFRowsS"], c["kFJ"])
    assert c["kFFlush"] * c["kFJ"] // 8 == cin.FLUSH
    assert c["kFMaxFields"] == cin.MAX_FIELDS >= 200

    def smem(m, stages=c["kFStages"]):
        stage = 2 * (c["kFCols"] + c["kFRowsL"]) * 128
        return stages * stage + m * c["kFCols"] * 4 + 2 * stages * 8
    assert smem(cin.MAX_FIELDS) <= c["kMaxSmem"] < smem(cin.MAX_FIELDS + 1)
    assert c["kFStageL"] == 2 * (c["kFCols"] + c["kFRowsL"]) * 128


def cin_wgrad_emulated(g, xk, x0, splits=1, cols=cin.WG_COLS,
                       flush=cin.WG_FLUSH):
    """``cin_weight_grad``'s arithmetic on float32 g [B, K, D], x_k [B, H,
    D], x_0 [B, M, D] -> float64 dw [K, H * M].  Each k-step of 8 columns
    adds its three TF32 products (lo.hi, hi.lo, hi.hi) into the float32
    accumulator, rounding after each; every ``flush`` k-steps (and at the
    end of a part) the accumulator goes into the Kahan pair and keeps the
    compensation; the parts (of ceil(stages / splits) stages of ``cols``)
    are added in float64."""
    B, K, D = g.shape
    H, M = xk.shape[1], x0.shape[1]
    z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(B, H * M, D)
    z = z.permute(0, 2, 1).reshape(B * D, H * M)       # [c, j]
    gc = g.permute(0, 2, 1).reshape(B * D, K)          # [c, k]
    pad = -(B * D) % cols
    z = torch.cat([z, torch.zeros(pad, H * M)])
    gc = torch.cat([gc, torch.zeros(pad, K)])
    steps = z.shape[0] // 8

    def prod(a, b):                    # [steps, K * H * M] float64
        return torch.einsum("sck,scj->skj", a.double().reshape(steps, 8, -1),
                            b.double().reshape(steps, 8, -1)
                            ).reshape(steps, -1).numpy()
    zh, zl = split(z, tf32)
    gh, gl = split(gc, tf32)
    terms = (prod(gh, zl), prod(gl, zh), prod(gh, zh))
    per_stage = cols // 8
    n_stages = steps // per_stage
    cps = math.ceil(n_stages / splits)
    total = np.zeros(K * H * M)
    f32 = np.float32
    for s in range(splits):
        lo, hi = s * cps * per_stage, min((s + 1) * cps, n_stages) * per_stage
        tot = np.zeros(K * H * M, f32)
        acc = np.zeros_like(tot)
        for i in range(lo, hi):
            for t in terms:
                acc = (acc + t[i]).astype(f32)
            if (i - lo + 1) % flush == 0 or i == hi - 1:
                u = (tot + acc).astype(f32)
                acc = (acc - (u - tot).astype(f32)).astype(f32)
                tot = u
        total += tot.astype(np.float64) + acc.astype(np.float64)
    return total.reshape(K, H * M)


@pytest.mark.parametrize("plan_splits", [False, True])
def test_cin_wgrad_emulation_holds_the_card_tolerance(plan_splits):
    """At the full reduction length (B = 65,536, D = 10: 81,920 k-steps,
    2,560 Kahan flushes in one part) and narrow outputs, the emulated
    kernel stays within chip_smoke's 3e-4 of the largest magnitude of
    float64, in one part (FULL's H = 200 case, whose 122 blocks fill the
    card) and in the parts ``wgrad_plan`` takes at this shape."""
    B, H, M, D, K = 65536, 4, 3, 10, 8
    rng = np.random.default_rng(11)
    g, xk, x0 = (rng.normal(size=s).astype(np.float32)
                 for s in ((B, K, D), (B, H, D), (B, M, D)))
    splits = cin.wgrad_plan(B, H, M, D, K)[0] if plan_splits else 1
    got = cin_wgrad_emulated(*map(torch.from_numpy, (g, xk, x0)), splits)
    exact = np.einsum("bkd,bhd,bmd->khm", g.astype(np.float64),
                      xk.astype(np.float64),
                      x0.astype(np.float64)).reshape(K, H * M)
    err = np.abs(got - exact).max()
    assert err <= 3e-4 * np.abs(exact).max(), (err, np.abs(exact).max())


def flash_bwd_f32_emulated(q, k, v, do, causal, q_tile=64, k_block=64):
    """The f32 backward's arithmetic on [BH, S, d] float32 tensors: every
    product as lo.hi + hi.lo + hi.hi of bf16 splits with one float32
    rounding, P and dS in float32 from the forward's float32 lse and o,
    dK and dV summed in float32 over query tiles, dQ over key blocks."""
    BH, S, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scale_log2 = float(np.float32(scale * math.log2(math.e)))
    logits = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * scale
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep = torch.tril(keep)
    logits = torch.where(keep, logits, -math.inf)
    lse = torch.logsumexp(logits, -1)
    o = torch.einsum("bqk,bkd->bqd", torch.exp(logits - lse[..., None]),
                     v.double()).float()
    lse = lse.float()

    def prod(a, b, eq):
        (ah, al), (bh, bl) = split(a, bf16), split(b, bf16)
        return (torch.einsum(eq, al.double(), bh.double())
                + torch.einsum(eq, ah.double(), bl.double())
                + torch.einsum(eq, ah.double(), bh.double())).float()
    s = prod(q, k, "bqd,bkd->bqk")
    p = torch.exp2(s * scale_log2 - lse[..., None] * float(np.float32(
        math.log2(math.e))))
    p = torch.where(keep, p, 0.0)
    dp = prod(do, v, "bqd,bkd->bqk")
    ds = p * (dp - (do * o).sum(-1)[..., None])
    dv = torch.zeros_like(v)
    dk = torch.zeros_like(k)
    for i0 in range(0, S, q_tile):
        rows = slice(i0, i0 + q_tile)
        dv += prod(p[:, rows].transpose(1, 2), do[:, rows], "bkq,bqd->bkd")
        dk += prod(ds[:, rows].transpose(1, 2), q[:, rows], "bkq,bqd->bkd")
    dq = torch.zeros_like(q)
    for k0 in range(0, S, k_block):
        cols = slice(k0, k0 + k_block)
        dq += prod(ds[:, :, cols], k[:, cols], "bqk,bkd->bqd")
    return dq * scale, dk * scale, dv


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_f32_split_bf16_emulation_holds_the_card_tolerance(causal):
    """f32 attention's gradients at S = 512, d = 128 on 2 heads: the
    emulated kernel within the card's 2e-3 of float64 gradients."""
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 512, 128)).astype(
        np.float32)) for _ in range(4))
    got = flash_bwd_f32_emulated(q, k, v, do, causal)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    logits = torch.einsum("bqd,bkd->bqk", leaves[0], leaves[1]) / math.sqrt(
        128)
    if causal:
        logits = logits.masked_fill(
            ~torch.tril(torch.ones(512, 512, dtype=torch.bool)), -math.inf)
    out = torch.einsum("bqk,bkd->bqd", torch.softmax(logits, -1), leaves[2])
    exact = torch.autograd.grad(out, leaves, do.double())
    for a, b in zip(got, exact):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-3)


def test_flash_bwd_wrapper_constants_match_the_kernel():
    """The backward's query tile and key block are the wrapper's, the
    sequence lengths' BLOCK covers them, and chip_smoke's planted fault
    drops that query tile."""
    c = _constexprs((CSRC / "flash_attn_bwd.cu").read_text())
    assert c["kBq"] == flash_attn.BWD_QUERY_TILE == 64
    assert c["kBk"] == flash_attn.BWD_KEY_BLOCK
    assert flash_attn.BLOCK % flash_attn.BWD_KEY_BLOCK == 0
    smoke = (CSRC.parents[3] / "chip_smoke.py").read_text()
    assert re.search(r"^BWD_QUERY_TILE = (\d+)", smoke, re.M).group(1) == \
        str(flash_attn.BWD_QUERY_TILE)


def test_flash_wrapper_block_covers_the_kernel_tiles():
    """The sequence lengths' BLOCK is a whole number of the bf16 kernel's
    query tiles (two warpgroups of 64 rows) and key tiles, and of the f32
    kernel's key tiles and query rows (8 warps of 16)."""
    c = _constexprs((CSRC / "flash_attn.cu").read_text())
    assert c["kBq"] == c["kBn"] == 128       # causal: one diagonal tile
    assert flash_attn.BLOCK % c["kBq"] == 0 and flash_attn.BLOCK % c["kBn"] == 0
    assert flash_attn.BLOCK % c["kBk"] == 0
    assert flash_attn.BLOCK % (16 * c["kWarps"]) == 0
