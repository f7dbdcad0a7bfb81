"""The bulk-synchronous SSSP round engine (port of ``repro/core/sssp/engine.py``).

Garg's four algorithms as configurations of one round body: per round,
relax, then fix every vertex one of the rules below certifies.

  R_min  — Dijkstra:          fix x with  D[x] == minD
  R_pred — SP1  (Lemma 2):    fix x whose in-edges are all relaxed
  R_in   — SP2  (Lemma 5):    fix x with  D[x] <= minD + inWeight_nf[x]
  R_out  — Lemma 8 (Crauser): fix x with  D[x] <= min(D+outWeight | ¬fixed)
  R_lb   — SP3/SP4 (Lem 6+7): fix x with  C[x] == D[x] after C-propagation

The state is batch-first: every vertex array is ``[B, n]`` (B = 1 for a
single solve), because ``torch.func.vmap`` cannot trace the data-dependent
loops.  Batched solves reproduce vmap-of-``while_loop`` exactly: the loop
runs while any lane's ``_cond`` holds, and finished lanes are
select-frozen, so per-lane ``rounds``/``fixed_by`` match a solo solve.

``lax.while_loop``/``lax.cond`` become Python control flow on a host
read.  Each read is one device->host sync and is counted in
``SyncCounter``: a dense round reads its termination predicate once; a
frontier round reads the termination predicate with the frontier count
(the overflow branch) at its top, the two cone-walk counts of the lb step
together, and the inWeight_nf walk count (three a round).  Every value a
round computes is a min, a max, a mask or one IEEE f32 add, so the
results are bitwise the reference's.

This is the cold path only: warm re-solves (A5), targets and ``C0``
seeds (A6) and ``_round``'s single-lane frontier branch (A7) are queued
in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import INF, Graph
from repro_torch.core.sssp import backends


@dataclasses.dataclass(frozen=True)
class SSSPConfig:
    rules: frozenset[str] = frozenset({"min", "pred", "in", "out", "lb"})
    label_correcting: bool = False   # SP4 relaxes all discovered edges
    c_prop_iters: int = 1            # Eqn-(1) applications per round
    max_rounds: int | None = None    # default n + 2
    use_pallas: bool = False         # selects the "pallas" backend in auto

    def __post_init__(self):
        unknown = self.rules - {"min", "pred", "in", "out", "lb"}
        if unknown:
            raise ValueError(f"unknown rules {unknown}")
        if not ({"min", "out"} & self.rules):
            raise ValueError("need 'min' or 'out' for progress guarantee")


SP1_RULES = frozenset({"min", "pred"})
SP2_RULES = frozenset({"min", "pred", "in"})
SP3_RULES = frozenset({"min", "pred", "in", "out", "lb"})
SP3_CONFIG = SSSPConfig(rules=SP3_RULES, label_correcting=False)
SP4_CONFIG = SSSPConfig(rules=SP3_RULES, label_correcting=True)


@dataclasses.dataclass
class SSSPState:
    D: torch.Tensor          # float32[B, n] upper bounds
    C: torch.Tensor          # float32[B, n] lower bounds
    fixed: torch.Tensor      # bool[B, n]
    explored: torch.Tensor   # bool[B, n]: fixed AND out-edges relaxed
    round: torch.Tensor      # int32[B]
    fixed_by: torch.Tensor   # int32[B, 5] cumulative per-rule fix counts
    edges: torch.Tensor | None = None       # int64[B] (frontier backend)
    # --- shared-batch-frontier carries (None outside _round_shared) ---
    in_w_nf: torch.Tensor | None = None     # float32[B, n]
    c_fix: torch.Tensor | None = None       # float32[B, n]
    cfix_stale: torch.Tensor | None = None  # bool[B, n]


@dataclasses.dataclass
class SSSPResult:
    """Distances and certificates for one source, with lazy parents."""

    dist: torch.Tensor
    C: torch.Tensor
    fixed: torch.Tensor
    rounds: int
    fixed_by: dict[str, int]
    source: int | None = None
    graph: Graph | None = None
    edges_relaxed: int | None = None   # frontier backend only
    host_syncs: int | None = None      # device->host reads of the solve
    _parents: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def parents(self) -> np.ndarray:
        """int32[n] shortest-path-tree parent per vertex (lazy, cached)."""
        if self._parents is None:
            if self.graph is None:
                raise ValueError("result carries no graph")
            from repro_torch.core.sssp.parents import parent_pointers
            self._parents = parent_pointers(self.graph,
                                            self.dist).cpu().numpy()
        return self._parents

    def path_to(self, target: int) -> list[int] | None:
        """Vertex list source..target along a shortest path, or None."""
        if self.source is None:
            raise ValueError("result carries no source vertex")
        from repro_torch.core.sssp.parents import extract_path
        return extract_path(self.parents(), int(target), int(self.source))


_RULE_ORDER = ("min", "pred", "in", "out", "lb")


def _fixed_by_dict(fixed_by) -> dict[str, int]:
    fb = np.asarray(fixed_by)
    return {r: int(c) for r, c in zip(_RULE_ORDER, fb)}


class SyncCounter:
    """Counts device->host reads; ``read`` is the only place a solve makes
    one.  It lifts torch's sync debug mode for its own read, so a caller
    that runs a solve under ``torch.cuda.set_sync_debug_mode("warn")``
    (or ``"error"``) is told of every other synchronizing call."""

    def __init__(self):
        self.count = 0

    def read(self, t: torch.Tensor) -> list:
        self.count += 1
        if not t.is_cuda:
            return t.tolist()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return t.tolist()
        finally:
            torch.cuda.set_sync_debug_mode(mode)


# ---------------------------------------------------------------------------
# Frontier compaction
# ---------------------------------------------------------------------------

def _csum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix count of a bool[n] mask."""
    return torch.cumsum(mask, 0, dtype=torch.int32)


def _count(csum: torch.Tensor) -> torch.Tensor:
    """int32 scalar: the number of True entries behind ``csum``."""
    if csum.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=csum.device)
    return csum[-1]


def _chunk(csum: torch.Tensor, start: int, cap: int) -> torch.Tensor:
    """int32[cap]: the True positions ``start .. start+cap-1`` of the mask
    behind ``csum`` in increasing order, padded with ``n``.  Entry k is
    the first index whose prefix count reaches k + 1 (``searchsorted``
    returns n past the last one) — the reference's cumsum compaction,
    without a scatter."""
    want = torch.arange(start + 1, start + cap + 1, dtype=torch.int32,
                        device=csum.device)
    return torch.searchsorted(csum, want, out_int32=True)


def _compact_frontier(mask: torch.Tensor, cap: int, n: int):
    """``(f_idx int32[cap], f_cnt int32 scalar)``: the first ``cap`` True
    positions of ``mask`` (padding ``n``) and the true count; ``f_cnt >
    cap`` flags overflow."""
    csum = _csum(mask)
    return _chunk(csum, 0, cap), _count(csum)


WALK_CELLS = 1 << 24   # per-lane cells one maintenance chunk may gather


def _walk_step(prims: backends.Primitives, B: int) -> int:
    """Sources per maintenance chunk: as many as ``WALK_CELLS`` gathered
    cells allow, never fewer than ``frontier_cap``, a power of two.

    The reference walks ``cap``-sized chunks inside a ``lax.while_loop``;
    here every chunk costs a Python dispatch of a few dozen launches, and
    the cone of an SP4 round on a grid holds about 40% of the vertices,
    so cap-sized chunks would cost ~100 dispatches a walk at n = 2^20.
    Chunking is exact at any size (see ``_chunked_apply``)."""
    fit = WALK_CELLS // max(1, B * prims.walk_width)
    step = 1 << max(0, fit.bit_length() - 1)
    return max(prims.frontier_cap, step)


def _chunked_apply(apply_chunk, csum: torch.Tensor, cnt: int, step: int,
                   carry: torch.Tensor) -> torch.Tensor:
    """Fold ``apply_chunk(chunk int32[step], ext) -> ext`` over ``step``-sized
    chunks of the True positions behind ``csum`` (``cnt`` of them, a host
    int read once per walk).

    ``carry`` float32[B, n] is copied once into ``ext``, a flat buffer
    of ``B * n + 1`` values whose last slot takes the writes the
    reference drops (padding targets ``n``); ``ext[:B*n]`` viewed as
    ``[B, n]`` is the result.  Chunks partition the walked sources and
    each update is a full recompute at its targets from values the walk
    does not write, so the chunk size never changes the result.
    """
    if cnt == 0:
        return carry
    B, n = carry.shape
    ext = torch.empty(B * n + 1, dtype=carry.dtype, device=carry.device)
    ext[: B * n].copy_(carry.reshape(-1))
    for start in range(0, cnt, step):
        ext = apply_chunk(_chunk(csum, start, min(step, cnt - start)), ext)
    return ext[: B * n].view(B, n)


def _scatter_set(ext: torch.Tensor, B: int, n: int, tgts: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``ext`` viewed as [B, n] gets ``[:, tgts] = vals``; targets ``>= n``
    land in the spare slot.  Duplicate targets carry equal values, so the
    result does not depend on the write order."""
    t = tgts.reshape(-1).long()
    lane = torch.arange(B, device=ext.device)[:, None] * n
    flat = torch.where((t < n)[None, :], lane + t[None, :], B * n)
    ext.index_put_((flat.reshape(-1),), vals.reshape(-1))
    return ext


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def _init_state(g: Graph, sources: torch.Tensor) -> SSSPState:
    """Cold state for int64[B] ``sources``: D = +inf but 0 at the source,
    C = 0, nothing fixed."""
    B = sources.shape[0]
    dev = g.device
    D = torch.full((B, g.n), INF, dtype=torch.float32, device=dev)
    D.scatter_(1, sources[:, None], 0.0)
    fixed = torch.zeros((B, g.n), dtype=torch.bool, device=dev)
    return SSSPState(D=D, C=torch.zeros_like(D), fixed=fixed,
                     explored=fixed,
                     round=torch.zeros(B, dtype=torch.int32, device=dev),
                     fixed_by=torch.zeros((B, 5), dtype=torch.int32,
                                          device=dev))


def _select(go: torch.Tensor, new: SSSPState, old: SSSPState) -> SSSPState:
    """Per-lane ``where(go, new, old)`` over every tensor of the state."""
    out = {}
    for f in dataclasses.fields(new):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if a is None:
            out[f.name] = None
        else:
            keep = go.reshape((-1,) + (1,) * (a.dim() - 1))
            out[f.name] = torch.where(keep, a, b)
    return SSSPState(**out)


def _cond(state: SSSPState, max_rounds: int) -> torch.Tensor:
    """bool[B] keep-going predicate per lane: something is discovered but
    not fixed, or fixed but not yet explored, within the round cap."""
    active = (state.D < INF) & ~state.fixed
    pending = state.fixed & ~state.explored
    return (active.any(dim=1) | pending.any(dim=1)) & (state.round
                                                       < max_rounds)


# ---------------------------------------------------------------------------
# Dense round
# ---------------------------------------------------------------------------

def _round(g: Graph, cfg: SSSPConfig, state: SSSPState,
           prims: backends.Primitives) -> SSSPState:
    """One bulk-synchronous dense round over ``[B, n]`` lanes — THE round
    body of the segment and ELL/pallas backends."""
    D, C, fixed = state.D, state.C, state.fixed

    # --- Step 1: relax FIRST, from previously-fixed (label-setting) or
    # all discovered (label-correcting) sources.
    relax_src = (D < INF) if cfg.label_correcting else fixed
    need_inw = ("in" in cfg.rules) or ("pred" in cfg.rules)
    D_relax = prims.relax(D, relax_src)
    in_w_nf = prims.in_weight_nf(~fixed) if need_inw else None
    D = torch.where(~fixed, torch.minimum(D, D_relax), D)
    explored = fixed

    discovered = D < INF
    active = discovered & ~fixed

    # --- Step 2: the heap minima of SP1–SP3, then the fixing rules.
    minD = prims.masked_min(D, active)[:, None]
    new_fix = torch.zeros_like(fixed)
    rule_counts = []

    def count(mask):
        rule_counts.append((mask & active & ~new_fix).sum(
            dim=1, dtype=torch.int32))
        return mask

    zero = torch.zeros(D.shape[0], dtype=torch.int32, device=D.device)
    if "min" in cfg.rules:
        new_fix = new_fix | count(active & (D <= minD))
    else:
        rule_counts.append(zero)
    if "pred" in cfg.rules:
        new_fix = new_fix | count(active & torch.isinf(in_w_nf))
    else:
        rule_counts.append(zero)
    if "in" in cfg.rules:
        new_fix = new_fix | count(active & (D <= minD + in_w_nf))
    else:
        rule_counts.append(zero)
    if "out" in cfg.rules:
        threshold = prims.masked_min(D + g.out_weight, active)[:, None]
        new_fix = new_fix | count(active & (D <= threshold))
    else:
        rule_counts.append(zero)

    fixed1 = fixed | new_fix

    # --- Step 3: Lemma-7 lift, then Eqn (1).
    if "lb" in cfg.rules:
        C = torch.where(fixed1, D, torch.maximum(C, minD))
        all_src = torch.ones_like(fixed)
        for _ in range(cfg.c_prop_iters):
            c_in = prims.relax(C, all_src)
            C = torch.where(~fixed1, torch.maximum(C, c_in), C)
        fix_lb = ~fixed1 & discovered & (C >= D)
        rule_counts.append(fix_lb.sum(dim=1, dtype=torch.int32))
        fixed2 = fixed1 | fix_lb
    else:
        rule_counts.append(zero)
        fixed2 = fixed1
    C = torch.where(fixed2, D, C)
    return SSSPState(
        D=D, C=C, fixed=fixed2, explored=explored, round=state.round + 1,
        fixed_by=state.fixed_by + torch.stack(rule_counts, dim=1))


def _solve(g: Graph, cfg: SSSPConfig, sources: torch.Tensor,
           prims: backends.Primitives, sync: SyncCounter) -> SSSPState:
    """Dense solve of int64[B] ``sources`` to fixpoint.  Frontier prims
    route to ``_solve_frontier`` (as the reference's ``_solve`` does for
    every frontier solve, B = 1 included)."""
    if prims.relax_frontier_b is not None:
        return _solve_frontier(g, cfg, sources, prims, sync)
    state = _init_state(g, sources)
    max_rounds = cfg.max_rounds or g.n + 2
    go = _cond(state, max_rounds)
    while sync.read(go.any()):
        state = _select(go, _round(g, cfg, state, prims), state)
        go = _cond(state, max_rounds)
    return state


# ---------------------------------------------------------------------------
# Shared-batch-frontier round
# ---------------------------------------------------------------------------

def _round_shared(g: Graph, cfg: SSSPConfig, state: SSSPState,
                  f_idx: torch.Tensor, f_cnt: int,
                  prims: backends.Primitives, sync: SyncCounter):
    """One round over ``[B, n]`` lanes sharing ONE compacted union
    frontier ``f_idx`` (``f_cnt`` its true size, already on the host).

    Same rules and order as ``_round``; only the execution differs:
    step 1 gathers the shared buffer once and scatter-mins per lane (B2),
    falling back to the dense relax when ``f_cnt > cap``; inWeight_nf is
    the incremental carry ``state.in_w_nf``; C-propagation is bounded to
    the cone of flipped-bit sources and sources with ``C > minD``, with
    the closed form ``max(C, min(c_fix, minD + inWeight_nf))`` off it.
    Returns ``(state, fresh)`` with ``fresh`` bool[B, n] the next-round
    frontier mask.
    """
    D, C, fixed = state.D, state.C, state.fixed          # [B, n]
    cap = prims.frontier_cap
    n = g.n
    B = D.shape[0]
    step = _walk_step(prims, B)
    relax_src = (D < INF) if cfg.label_correcting else fixed

    # --- Step 1: shared-buffer D relaxation --------------------------
    overflow = cap < n and f_cnt > cap
    if overflow:
        D_relax = prims.relax(D, relax_src)
    else:
        D_relax = prims.relax_frontier_b(D, f_idx, relax_src)
    if overflow:
        edges = state.edges + g.e_pad
    else:
        u = f_idx.clamp(max=n - 1).long()
        live = (f_idx < n)[None, :] & relax_src[:, u]
        edges = state.edges + torch.where(
            live, g.out_deg[u][None, :], 0).sum(dim=1, dtype=torch.int64)

    in_w_nf = state.in_w_nf    # invariant: == in_weight_nf(~round-start fixed)
    cfix_stale = state.cfix_stale
    D = torch.where(~fixed, torch.minimum(D, D_relax), D)
    explored = fixed

    discovered = D < INF
    active = discovered & ~fixed

    # --- Step 2: per-lane reductions + fixing rules ------------------
    minD = prims.masked_min(D, active)[:, None]
    new_fix = torch.zeros_like(fixed)
    rule_counts = []

    def count(mask):
        rule_counts.append((mask & active & ~new_fix).sum(
            dim=1, dtype=torch.int32))
        return mask

    zero = torch.zeros(B, dtype=torch.int32, device=D.device)
    if "min" in cfg.rules:
        new_fix = new_fix | count(active & (D <= minD))
    else:
        rule_counts.append(zero)
    if "pred" in cfg.rules:
        new_fix = new_fix | count(active & torch.isinf(in_w_nf))
    else:
        rule_counts.append(zero)
    if "in" in cfg.rules:
        new_fix = new_fix | count(active & (D <= minD + in_w_nf))
    else:
        rule_counts.append(zero)
    if "out" in cfg.rules:
        threshold = prims.masked_min(D + g.out_weight[None, :],
                                     active)[:, None]
        new_fix = new_fix | count(active & (D <= threshold))
    else:
        rule_counts.append(zero)

    fixed1 = fixed | new_fix

    # --- Step 3: cone-bounded C update (Lemma 7 lift + Eqn (1)) ------
    if "lb" in cfg.rules:
        stale_src = cfix_stale | new_fix
        s_csum = _csum(stale_src.any(dim=0))
        C = torch.where(fixed1, D, torch.maximum(C, minD))

        def prop_csum(C):
            prop_src = stale_src | (~fixed1 & (C > minD))
            return _csum(prop_src.any(dim=0))

        # the c_fix walk does not touch C, so the first cone's count is
        # read together with the c_fix walk's: one sync for both
        p_csum = prop_csum(C)
        s_cnt, p_cnt = sync.read(torch.stack([_count(s_csum),
                                              _count(p_csum)]))

        # (a) c_fix maintenance at out-neighbours of flipped-bit sources
        def cfix_chunk(chunk, ext):
            tgts = prims.out_nbrs(chunk)              # [cap, max_out]
            vals = prims.in_min_at(D, tgts, fixed1)   # [B, cap, max_out]
            return _scatter_set(ext, B, n, tgts, vals)

        c_fix = _chunked_apply(cfix_chunk, s_csum, s_cnt, step, state.c_fix)

        # (b) propagate lower bounds through the cone only
        for it in range(cfg.c_prop_iters):
            if it:
                p_csum = prop_csum(C)
                p_cnt = sync.read(_count(p_csum))
            base = torch.minimum(c_fix, minD + in_w_nf)   # off-cone form
            C_new = torch.where(~fixed1, torch.maximum(C, base), C)
            C_pre = C

            def prop_chunk(chunk, ext, C_pre=C_pre):
                tgts = prims.out_nbrs(chunk)
                cin = prims.in_min_at(C_pre, tgts, None)  # all sources
                tc = tgts.clamp(max=n - 1).long()
                cur = C_pre[:, tc]
                upd = ~fixed1[:, tc] & (tgts < n)[None]
                val = torch.where(upd, torch.maximum(cur, cin), cur)
                return _scatter_set(ext, B, n, tgts, val)

            C = _chunked_apply(prop_chunk, p_csum, p_cnt, step, C_new)

        fix_lb = ~fixed1 & discovered & (C >= D)
        rule_counts.append(fix_lb.sum(dim=1, dtype=torch.int32))
        fixed2 = fixed1 | fix_lb
        C = torch.where(fixed2, D, C)
        cfix_stale = fix_lb   # applied at the NEXT round's maintenance
    else:
        rule_counts.append(zero)
        fixed2 = fixed1
        C = torch.where(fixed2, D, C)
        c_fix = state.c_fix

    # --- incremental inWeight_nf refresh for round-start fixed2 -------
    if in_w_nf is not None:
        w_csum = _csum((state.fixed ^ fixed2).any(dim=0))
        w_cnt = sync.read(_count(w_csum))

        def inw_chunk(chunk, ext):
            tgts = prims.out_nbrs(chunk)
            vals = prims.in_min_at(None, tgts, ~fixed2)   # min weight
            return _scatter_set(ext, B, n, tgts, vals)

        in_w_nf = _chunked_apply(inw_chunk, w_csum, w_cnt, step, in_w_nf)

    # --- next-round frontier mask -------------------------------------
    if cfg.label_correcting:
        fresh = D != state.D
    else:
        fresh = fixed2 & (~state.fixed | (D != state.D))
    new_state = SSSPState(
        D=D, C=C, fixed=fixed2, explored=explored, round=state.round + 1,
        fixed_by=state.fixed_by + torch.stack(rule_counts, dim=1),
        edges=edges, in_w_nf=in_w_nf, c_fix=c_fix, cfix_stale=cfix_stale)
    return new_state, fresh


def _attach_carries(g: Graph, cfg: SSSPConfig, prims: backends.Primitives,
                    state: SSSPState) -> SSSPState:
    """Seed the shared-frontier carries onto a fresh ``[B, n]`` state
    (dense reductions, once per solve, outside the round loop)."""
    B = state.D.shape[0]
    need_inw = bool({"in", "pred", "lb"} & cfg.rules)
    use_lb = "lb" in cfg.rules
    return dataclasses.replace(
        state, edges=torch.zeros(B, dtype=torch.int64, device=g.device),
        in_w_nf=prims.in_weight_nf(~state.fixed) if need_inw else None,
        c_fix=prims.relax(state.D, state.fixed) if use_lb else None,
        cfix_stale=torch.zeros_like(state.fixed) if use_lb else None)


def _strip_carries(state: SSSPState) -> SSSPState:
    return dataclasses.replace(state, in_w_nf=None, c_fix=None,
                               cfix_stale=None)


def _frontier_fixpoint(g: Graph, cfg: SSSPConfig, prims: backends.Primitives,
                       state: SSSPState, f_idx: torch.Tensor,
                       f_cnt: torch.Tensor, max_rounds: int,
                       sync: SyncCounter) -> SSSPState:
    """Shared-frontier loop over ``[B, n]`` lanes: one union compaction
    per round; run while any lane's ``_cond`` holds and select-freeze the
    finished lanes.  The termination predicate and the frontier count
    (which picks the overflow branch) come back in one host read."""
    cap = prims.frontier_cap
    go = _cond(state, max_rounds)
    while True:
        more, cnt = sync.read(torch.stack([go.any().to(torch.int32),
                                           f_cnt.to(torch.int32)]))
        if not more:
            return state
        st2, fresh = _round_shared(g, cfg, state, f_idx, cnt, prims, sync)
        state = _select(go, st2, state)
        union = (fresh & go[:, None]).any(dim=0)
        f_idx, f_cnt = _compact_frontier(union, cap, g.n)
        go = _cond(state, max_rounds)


def _solve_frontier(g: Graph, cfg: SSSPConfig, sources: torch.Tensor,
                    prims: backends.Primitives,
                    sync: SyncCounter) -> SSSPState:
    """Batched frontier solve of int64[B] ``sources``: B lanes, ONE shared
    union frontier seeded with the union of the sources."""
    state = _attach_carries(g, cfg, prims, _init_state(g, sources))
    src_mask = torch.zeros(g.n, dtype=torch.bool, device=g.device)
    src_mask.index_fill_(0, sources, True)
    f_idx, f_cnt = _compact_frontier(src_mask, prims.frontier_cap, g.n)
    max_rounds = cfg.max_rounds or g.n + 2
    state = _frontier_fixpoint(g, cfg, prims, state, f_idx, f_cnt,
                               max_rounds, sync)
    return _strip_carries(state)
