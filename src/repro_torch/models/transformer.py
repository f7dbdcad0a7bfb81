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
  * ``ShardingHooks`` has no counterpart: on one card they are the
    identity.  ``remat``, ``remat_policy`` and ``scan_unroll`` are kept so
    the configs copy verbatim, and do nothing here.
  * Training (``loss_fn``) is not ported: B6 has no backward.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import resolve_device
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


def attention_qkv(lp: dict, x: torch.Tensor, cfg: LMConfig, rope):
    """A layer's q [B, S, Hkv, G, hd], k and v [B, S, Hkv, hd] from the
    residual stream ``x`` [B, S, d], normed and roped; ``rope`` is the
    ``(cos, sin)`` tables of the S positions or, for one decode step, the
    host integer position."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // Hkv
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, Hkv, G, hd)
    k = (h @ lp["wk"]).reshape(B, S, Hkv, hd)
    v = (h @ lp["wv"]).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = q.reshape(B, S, H, hd)
    if isinstance(rope, int):
        q = apply_rope_at(q, rope, hd, cfg.rope_theta)
        k = apply_rope_at(k, rope, hd, cfg.rope_theta)
    else:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    return q.reshape(B, S, Hkv, G, hd), k, v


def _prompt_attention(q, k, v, cfg: LMConfig, i: int) -> torch.Tensor:
    if cfg.layer_is_global(i):
        return attn_lib.flash_attention_gqa(q, k, v, causal=True)
    return attn_lib.chunked_local_attention(q, k, v, chunk=cfg.local_chunk)


def _ffn_block(lp: dict, x: torch.Tensor, cfg: LMConfig,
               moe_cfg: MoEConfig | None):
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if "moe" in lp:
        return moe_ffn(lp["moe"], h, moe_cfg)
    return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), {}


def _layers(params: dict, x: torch.Tensor, cfg: LMConfig, moe_cfg,
            cache: "KVCache | None" = None):
    """The prompt pass: every layer over all S positions of ``x``, one B6
    launch each.  With ``cache``, each layer's k/v go into it as S decode
    steps would leave them.  Returns x and the summed aux losses."""
    B, S, _ = x.shape
    rope = rope_frequencies(cfg.hd, S, cfg.rope_theta, device=x.device)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        q, k, v = attention_qkv(lp, x, cfg, rope)
        if cache is not None:
            _fill(cache, i, k, v)
        o = _prompt_attention(q, k, v, cfg, i)
        x = x + o.reshape(B, S, -1) @ lp["wo"]
        f, aux = _ffn_block(lp, x, cfg, moe_cfg)
        x = x + f
        if aux:
            lb = lb + aux["moe_lb"]
            z = z + aux["moe_z"]
    return x, {"moe_lb": lb, "moe_z": z}


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig):
    """tokens [B, S] -> logits [B, S, vocab] (f32), aux loss dict."""
    x = params["embed"][tokens]
    x, aux = _layers(params, x, cfg, cfg.moe)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float(), aux


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            z_weight: float = 1e-4):
    """``batch["tokens"]`` [B, S+1] -> (scalar loss, metrics): the mean
    next-token NLL (``lse - gold``) plus ``z_weight * mean(lse^2)`` plus
    the MoE aux losses, over ``forward`` at the config's training
    capacity (MoE drops included, as in the reference)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(params, inputs, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = torch.mean(lse - gold)
    zloss = z_weight * torch.mean(lse ** 2)
    loss = nll + zloss + aux["moe_lb"] + aux["moe_z"]
    return loss, {"nll": nll, "zloss": zloss, **aux}


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
                cfg: LMConfig):
    """token [B] int -> logits [B, vocab] (f32) and the cache at pos + 1.

    The K/V tensors of ``cache`` are written in place (the returned cache
    shares them)."""
    B = token.shape[0]
    x = params["embed"][token][:, None, :]        # [B, 1, d]
    pos = cache.pos
    for i, lp in enumerate(params["layers"]):
        q, k, v = attention_qkv(lp, x, cfg, pos)
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
        cache.k[i][:, slot] = k[:, 0].to(cache.k[i].dtype)
        cache.v[i][:, slot] = v[:, 0].to(cache.v[i].dtype)
        o = attn_lib.decode_attention(q, cache.k[i], cache.v[i], length)
        x = x + o.reshape(B, 1, -1) @ lp["wo"]
        f, _ = _ffn_block(lp, x, cfg, cfg.moe)
        x = x + f
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"])[:, 0]
    return logits.float(), KVCache(k=cache.k, v=cache.v, pos=pos + 1)


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
