"""LM serving loop (port of ``repro/runtime/serve_loop.py``): batched
prefill + decode against a KV cache, greedy or temperature sampling, and
simple continuous batching over a request list.

``BatchServer`` keeps the reference's semantics: a group of up to
``batch`` requests shares one cache; prompts are left-padded with token
0 to a rectangle and the pad tokens are attended.  The group's prompts
go through the port's batched ``prefill`` (one B6 launch a layer) in
place of one decode step a prompt token; then ``max_new`` decode steps
follow, one sampled token each.  Sampling draws from the server's own
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import resolve_device
from repro_torch.models.transformer import (KVCache, LMConfig, decode_step,
                                            prefill)


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new: int = 32
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def make_serve_step(cfg: LMConfig):
    """One decode step for a whole batch: ``serve_step(params, cache,
    token)`` -> (logits [B, vocab] f32, cache)."""
    @torch.inference_mode()
    def serve_step(params: dict, cache: KVCache, token: torch.Tensor):
        return decode_step(params, cache, token, cfg)
    return serve_step


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 temperature: float = 0.0) -> torch.Tensor:
    """int32 [B]: argmax at ``temperature <= 0``, else a draw from
    softmax(logits / temperature) with ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class BatchServer:
    """Fixed batch slots; a group of requests runs to its longest
    ``max_new`` before the next group starts (the whole batch restarts
    when all slots drain, which keeps the cache dense)."""

    def __init__(self, params: dict, cfg: LMConfig, batch: int,
                 max_seq: int, temperature: float = 0.0, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"parameters on {params['embed'].device}, "
                             f"server on {self.device}")
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.temp = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.step_fn = make_serve_step(cfg)

    def generate(self, requests: list[Request]) -> list[Request]:
        for group_start in range(0, len(requests), self.batch):
            self._run_group(requests[group_start: group_start + self.batch])
        return requests

    @torch.inference_mode()
    def _run_group(self, group: list[Request]) -> None:
        B = self.batch
        max_prompt = max(len(r.prompt) for r in group)
        # left-pad prompts to a rectangle; one batched prefill
        toks = np.zeros((B, max_prompt), np.int32)
        for i, r in enumerate(group):
            toks[i, max_prompt - len(r.prompt):] = r.prompt
        logits, cache = prefill(self.params,
                                torch.from_numpy(toks).to(self.device),
                                self.cfg, self.max_seq)
        max_new = max(r.max_new for r in group)
        for _ in range(max_new):
            cur = sample_token(logits, self.generator, self.temp)
            host = cur.tolist()
            for i, r in enumerate(group):
                if len(r.out) < r.max_new:
                    r.out.append(host[i])
                else:
                    r.done = True
            logits, cache = self.step_fn(self.params, cache, cur)
        for r in group:
            r.done = True
