"""Decoder-only LM (port of ``repro/models/transformer.py``): dense and
MoE, GQA, RoPE, qk-norm, chunked-local attention, for training and
serving.

One parameterised architecture covers the five LM configs
(``repro_torch.configs``).  Differences from the reference:

  * ``params["layers"]`` is a list of per-layer dicts, not tensors
    stacked per super-block; ``convert.lm_params_from_arrays`` unstacks
    the reference's tree.  Eager PyTorch has no scan to keep small.
  * Prompt attention is one B6 launch a layer (``models/attention``);
    ``forward`` and ``prefill`` both take it, and ``loss_fn``'s backward
    one launch of B6's backward kernel a layer.
  * ``prefill`` computes the reference's function (a cache filled by one
    ``decode_step`` a prompt token) in one batched pass through the
    layers, and takes the head only at the last position.  Its MoE
    layers run at a capacity where nothing drops (``moe.no_drop``), as
    decode never drops; only teacher-forced ``forward`` keeps the
    config's drops.
  * ``decode_step`` writes the cache in place and keeps ``pos`` on the
    host, so a step reads nothing back from the card.
  * ``ShardingHooks`` redistribute a DTensor to the sharding rules'
    layout at the reference's sites (``distributed/sharding.lm_hooks``);
    on plain tensors every hook is the identity, so one card keeps its
    bits.  Parameters and batches placed as DTensors by the rules run
    the same code, DTensor inserting the collectives.  The query heads
    stay ``[B, S, H, hd]`` up to B6 (a DTensor cannot split a sharded H
    into (Hkv, G) when the model axis does not divide Hkv).  ``remat``,
    ``remat_policy`` and ``scan_unroll`` are kept so the configs copy
    verbatim, and do nothing here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.graph import resolve_device
from repro_torch.distributed.layout import (hold_layout, is_dtensor,
                                            local_block, whole_rows,
                                            write_slot)
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (apply_rope, apply_rope_at,
                                       normal_init, rms_norm,
                                       rope_frequencies)
from repro_torch.models.moe import (MoEConfig, init_moe_params, moe_ffn,
                                    no_drop, swiglu)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    qk_norm: bool = False                # qwen3
    moe: MoEConfig | None = None
    moe_every: int = 1                   # 2 = alternating dense/MoE
    attn_kind: str = "full"              # "full" | "chunked_local"
    local_chunk: int = 8192              # llama4 chunk size
    global_every: int = 4                # every Nth layer is global
    rope_theta: float = 5e5
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    remat: bool = True                   # inert in the port
    remat_policy: str = "full"           # inert in the port
    max_seq: int = 8192                  # rope table length for training
    scan_unroll: bool = False            # inert in the port

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def sub_quadratic(self) -> bool:
        return self.attn_kind == "chunked_local"

    def layer_is_global(self, i: int) -> bool:
        if self.attn_kind == "full":
            return True
        return (i % self.global_every) == (self.global_every - 1)

    def layer_is_moe(self, i: int) -> bool:
        if not self.moe:
            return False
        return (i % self.moe_every) == (self.moe_every - 1)

    @property
    def n_moe_layers(self) -> int:
        return sum(self.layer_is_moe(i) for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, hd, H, Hkv, L = (self.d_model, self.hd, self.n_heads,
                            self.n_kv_heads, self.n_layers)
        attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d + 2 * d
        if self.qk_norm:
            attn += 2 * hd
        dense_ffn = 3 * d * self.d_ff
        total = self.vocab * d * 2 + d + L * attn
        for i in range(L):
            if self.layer_is_moe(i):
                E, f = self.moe.n_experts, self.moe.d_ff_expert
                total += d * E + 3 * E * d * f
                if self.moe.n_shared:
                    total += 3 * d * f * self.moe.n_shared
            else:
                total += dense_ffn
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        E, f, K = self.moe.n_experts, self.moe.d_ff_expert, self.moe.top_k
        nm = self.n_moe_layers
        return self.param_count() - nm * 3 * E * d * f + nm * 3 * K * d * f


def _identity(x):
    return x


@dataclasses.dataclass
class ShardingHooks:
    """Layout constraints at the activation boundaries (the reference's);
    each maps a tensor to itself or, under DTensor, to the rule's
    placements."""
    act: Callable = _identity            # [B, S, d] residual stream
    moe_buf: Callable | None = None      # [B, E, C, d] dispatch buffer
    logits: Callable = _identity         # [B, S, vocab]
    cache: Callable = _identity          # KV cache entries
    # sequence-parallel attention (archs whose head count doesn't divide
    # the model axis): queries shard S over `model`, K/V replicate
    attn_q: Callable | None = None       # [B, S, H, hd]
    attn_kv: Callable | None = None      # [B, S, Hkv, hd]


_NO_HOOKS = ShardingHooks()


def _init_layer(generator, cfg: LMConfig, moe: bool, device) -> dict:
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.dtype

    def draw(shape, scale):
        return normal_init(generator, shape, scale, dt, device)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    p = {"attn_norm": ones(d), "ffn_norm": ones(d),
         "wq": draw((d, H * hd), d ** -0.5),
         "wk": draw((d, Hkv * hd), d ** -0.5),
         "wv": draw((d, Hkv * hd), d ** -0.5),
         "wo": draw((H * hd, d), (H * hd) ** -0.5)}
    if cfg.qk_norm:
        p["q_norm"] = ones(hd)
        p["k_norm"] = ones(hd)
    if moe:
        p["moe"] = init_moe_params(generator, cfg.moe, d, dt, device)
    else:
        p["w_gate"] = draw((d, cfg.d_ff), d ** -0.5)
        p["w_up"] = draw((d, cfg.d_ff), d ** -0.5)
        p["w_down"] = draw((cfg.d_ff, d), cfg.d_ff ** -0.5)
    return p


def init_params(cfg: LMConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights drawn from ``generator`` (which lives on
    ``device``), scaled as the reference scales them; ``layers`` is a
    list of per-layer dicts."""
    device = resolve_device(device)
    embed = normal_init(generator, (cfg.vocab, cfg.d_model), 0.02,
                        cfg.dtype, device)
    head = normal_init(generator, (cfg.d_model, cfg.vocab),
                       cfg.d_model ** -0.5, cfg.dtype, device)
    layers = [_init_layer(generator, cfg, cfg.layer_is_moe(i), device)
              for i in range(cfg.n_layers)]
    return {"embed": embed, "lm_head": head,
            "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                     device=device),
            "layers": layers}


def attention_qkv(lp: dict, x: torch.Tensor, cfg: LMConfig, rope,
                  hooks: ShardingHooks = _NO_HOOKS):
    """A layer's q [B, S, H, hd], k and v [B, S, Hkv, hd] from the
    residual stream ``x`` [B, S, d], normed and roped; ``rope`` is the
    ``(cos, sin)`` tables of the S positions or, for one decode step, the
    host integer position.  Query head ``h`` is the reference's ``(h //
    G, h % G)`` of ``[B, S, Hkv, G, hd]``."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = whole_rows(rms_norm(x, lp["attn_norm"], cfg.norm_eps))
    q = _split_heads(h @ lp["wq"], H, hd)
    k = _split_heads(h @ lp["wk"], Hkv, hd)
    v = _split_heads(h @ lp["wv"], Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    if isinstance(rope, int):
        q = apply_rope_at(q, rope, hd, cfg.rope_theta)
        k = apply_rope_at(k, rope, hd, cfg.rope_theta)
    else:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    if hooks.attn_q is not None:
        q = hooks.attn_q(q)
    if hooks.attn_kv is not None:
        k = hooks.attn_kv(k)
        v = hooks.attn_kv(v)
    return q, k, v


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n*hd] -> [B, S, n, hd].  A DTensor sharded on the last dim
    over more ranks than divide ``n`` is gathered first (a DTensor cannot
    split its shards across heads)."""
    B, S, _ = t.shape
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        mesh = t.device_mesh
        k = 1
        for md, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim == 2:
                k *= mesh.size(md)
        if n % k:
            t = t.redistribute(mesh, tuple(
                Replicate() if isinstance(p, Shard) and p.dim == 2 else p
                for p in t.placements))
    return t.reshape(B, S, n, hd)


def _prompt_attention(q, k, v, cfg: LMConfig, i: int) -> torch.Tensor:
    if cfg.layer_is_global(i):
        return attn_lib.flash_attention_gqa(q, k, v, causal=True)
    return attn_lib.chunked_local_attention(q, k, v, chunk=cfg.local_chunk)


def _ffn_block(lp: dict, x: torch.Tensor, cfg: LMConfig,
               moe_cfg: MoEConfig | None, hooks: ShardingHooks = _NO_HOOKS):
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if "moe" not in lp:
        h = whole_rows(h)
    if "moe" in lp:
        return moe_ffn(lp["moe"], h, moe_cfg, ep_constraint=hooks.moe_buf)
    return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), {}


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(params["embed"]):
        return _embed_sharded(params["embed"], tokens)
    return params["embed"][tokens]


def _embed_sharded(table, tokens):
    """Vocabulary-parallel lookup (``local_map``): each rank looks up the
    tokens inside its block of rows, zeros elsewhere; the result is a
    partial sum over the axes that shard the vocabulary (the act hook
    sums it)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tp = tuple(table.placements)
    rows = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else
                 Replicate() for p in tokens.placements)
    out = tuple(Partial() if isinstance(p, Shard) else r
                for p, r in zip(tp, rows))
    lo, width = local_block(table, 0)

    def lookup(tab, tok):
        t = tok - lo
        inside = (t >= 0) & (t < width)
        e = F.embedding(t.clamp(0, width - 1), tab)
        return torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype))
    return local_map(lookup, out_placements=(out,), in_placements=(tp, rows),
                     device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def _layers(params: dict, x: torch.Tensor, cfg: LMConfig, moe_cfg,
            cache: "KVCache | None" = None,
            hooks: ShardingHooks = _NO_HOOKS):
    """The prompt pass: every layer over all S positions of ``x``, one B6
    launch each.  With ``cache``, each layer's k/v go into it as S decode
    steps would leave them.  Returns x and the summed aux losses."""
    B, S, _ = x.shape
    rope = rope_frequencies(cfg.hd, S, cfg.rope_theta, device=x.device)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        q, k, v = attention_qkv(lp, x, cfg, rope, hooks)
        if cache is not None:
            _fill(cache, i, k, v)
        o = _prompt_attention(q, k, v, cfg, i)
        # each branch's output laid out as the residual stream before the
        # sum (identities on one card; under DTensor the row-parallel
        # product's reduction, and its adjoint in the backward)
        o = hold_layout(o.reshape(B, S, -1))
        x = hooks.act(x + hooks.act(o @ lp["wo"]))
        f, aux = _ffn_block(lp, x, cfg, moe_cfg, hooks)
        x = hooks.act(x + hooks.act(f))
        if aux:
            lb = lb + aux["moe_lb"]
            z = z + aux["moe_z"]
    return x, {"moe_lb": lb, "moe_z": z}


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            hooks: ShardingHooks | None = None):
    """tokens [B, S] -> logits [B, S, vocab] (f32), aux loss dict."""
    hooks = hooks or _NO_HOOKS
    x = hooks.act(_embed(params, tokens))
    x, aux = _layers(params, x, cfg, cfg.moe, hooks=hooks)
    x = whole_rows(rms_norm(x, params["final_norm"], cfg.norm_eps))
    return hooks.logits((x @ params["lm_head"]).float()), aux


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            hooks: ShardingHooks | None = None, z_weight: float = 1e-4):
    """``batch["tokens"]`` [B, S+1] -> (scalar loss, metrics): the mean
    next-token NLL (``lse - gold``) plus ``z_weight * mean(lse^2)`` plus
    the MoE aux losses, over ``forward`` at the config's training
    capacity (MoE drops included, as in the reference)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(params, inputs, cfg, hooks)
    lse, gold = _lse_gold(logits, targets)
    nll = torch.mean(lse - gold)
    zloss = z_weight * torch.mean(lse ** 2)
    loss = nll + zloss + aux["moe_lb"] + aux["moe_z"]
    return loss, {"nll": nll, "zloss": zloss, **aux}


def _lse_gold(logits: torch.Tensor, targets: torch.Tensor):
    """Each position's log-sum-exp over the vocabulary and its target's
    logit.  A DTensor ``logits`` sharded over the vocabulary takes
    ``_lse_gold_sharded``."""
    if is_dtensor(logits):
        return _lse_gold_sharded(logits, targets)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    return lse, gold


def _lse_gold_sharded(logits, targets):
    """Vocabulary-parallel ``_lse_gold`` (``local_map``): each rank takes
    the max, the sum of exponentials and the target's logit over its block
    of the vocabulary; a max and two sums over the model axis combine
    them, [B, S] values where the plain version would gather the whole
    ``[B, S, vocab]`` logits."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    vdim = logits.dim() - 1
    lp = tuple(logits.placements)
    rows = tuple(Replicate() if isinstance(p, Shard) and p.dim == vdim
                 else p for p in lp)
    lo, width = local_block(logits, vdim)

    def part(op):
        return tuple(Partial(op) if isinstance(p, Shard) and p.dim == vdim
                     else p for p in lp)

    def local_max(lg):
        return lg.detach().amax(dim=-1)
    m = local_map(local_max, out_placements=(part("max"),),
                  in_placements=(lp,), device_mesh=mesh)(logits)
    m = m.redistribute(mesh, rows)

    def sums(lg, mx, tg):
        se = torch.exp(lg - mx[..., None]).sum(-1)
        t = tg.long() - lo
        inside = (t >= 0) & (t < width)
        g = lg.gather(-1, t.clamp(0, width - 1)[..., None])[..., 0]
        return se, torch.where(inside, g, 0.0)
    se, gold = local_map(sums, out_placements=(part("sum"), part("sum")),
                         in_placements=(lp, rows, rows), device_mesh=mesh,
                         redistribute_inputs=True)(logits, m, targets)
    se = se.redistribute(mesh, rows)
    gold = gold.redistribute(mesh, rows)
    return m + torch.log(se), gold


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Per-layer K/V tensors [B, S_l, Hkv, hd] and the number of tokens
    decoded so far (a host integer).  Local (chunked) layers hold only
    ``min(chunk, max_seq)`` slots."""
    k: list
    v: list
    pos: int


def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> KVCache:
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    ks, vs = [], []
    for i in range(cfg.n_layers):
        s = max_seq if cfg.layer_is_global(i) else min(cfg.local_chunk,
                                                       max_seq)
        shape = (batch, s, cfg.n_kv_heads, cfg.hd)
        ks.append(torch.zeros(shape, dtype=dtype, device=device))
        vs.append(torch.zeros(shape, dtype=dtype, device=device))
    return KVCache(k=ks, v=vs, pos=0)


def _fill(cache: KVCache, i: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Layer ``i``'s cache as S decode steps from position 0 leave it:
    a global layer holds positions 0..S-1; a local layer of s_l slots
    holds, at slot t % s_l, the last of the positions t < S that map
    there (the last s_l positions)."""
    S = k.shape[1]
    s_l = cache.k[i].shape[1]
    lo = max(0, S - s_l)
    slots = torch.arange(lo, S, device=k.device) % s_l
    cache.k[i][:, slots] = k[:, lo:].to(cache.k[i].dtype)
    cache.v[i][:, slots] = v[:, lo:].to(cache.v[i].dtype)


def decode_step(params: dict, cache: KVCache, token: torch.Tensor,
                cfg: LMConfig, hooks: ShardingHooks | None = None):
    """token [B] int -> logits [B, vocab] (f32) and the cache at pos + 1.

    The K/V tensors of ``cache`` are written in place (the returned cache
    shares them)."""
    hooks = hooks or _NO_HOOKS
    B = token.shape[0]
    x = hooks.act(_embed(params, token)[:, None, :])   # [B, 1, d]
    pos = cache.pos
    for i, lp in enumerate(params["layers"]):
        q, k, v = attention_qkv(lp, x, cfg, pos, hooks)
        s_l = cache.k[i].shape[1]
        if cfg.layer_is_global(i):
            if pos >= s_l:
                raise ValueError(f"the cache holds {s_l} positions; "
                                 f"cannot decode position {pos}")
            slot, length = pos, pos + 1
        else:
            # local layers see the current chunk only (slots 0..pos % s_l)
            slot = pos % s_l
            length = slot + 1
        _write_slot(cache.k[i], slot, k[:, 0])
        _write_slot(cache.v[i], slot, v[:, 0])
        kc, vc = hooks.cache(cache.k[i]), hooks.cache(cache.v[i])
        o = attn_lib.decode_attention(q, kc, vc, length)
        x = x + o.reshape(B, 1, -1) @ lp["wo"]
        f, _ = _ffn_block(lp, x, cfg, cfg.moe, hooks)
        x = x + f
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"])[:, 0]
    return logits.float(), KVCache(k=cache.k, v=cache.v, pos=pos + 1)


def _write_slot(cache: torch.Tensor, slot: int, val: torch.Tensor) -> None:
    """``cache[:, slot] = val`` in place; a DTensor cache takes the value
    in its own layout (the rank holding the slot writes it)."""
    val = val.to(cache.dtype)
    if is_dtensor(cache):
        write_slot(cache, slot, val)
    else:
        cache[:, slot] = val


def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            max_seq: int):
    """Run the prompt ``tokens`` [B, S] through the model, filling a
    cache of ``max_seq`` positions: the last position's logits [B, vocab]
    (f32) and the cache at pos = S, as S ``decode_step``s from an empty
    cache give them, computed in one batched pass (one B6 launch a
    layer).  MoE layers run at a capacity where nothing drops."""
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"{max_seq} positions")
    cache = init_cache(cfg, B, max_seq, device=tokens.device)
    x = params["embed"][tokens]
    x, _ = _layers(params, x, cfg, cfg.moe and no_drop(cfg.moe), cache)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"])[:, 0].float()
    return logits, KVCache(k=cache.k, v=cache.v, pos=S)
