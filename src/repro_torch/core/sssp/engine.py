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

Besides cold solves the engine runs:

  * targeted solves: lane b stops once ``targets[b] >= 0`` is fixed and
    explored (``_cond``), and ``C0`` seeds the lower bounds
    (``_init_state``);
  * warm re-solves after a weight delta (``core/sssp/dynamic.py``):
    ``delta_taint_seeds`` marks the heads of increased tight edges, the
    taint sweeps of ``_init_state_warm`` (one host read a sweep) grow
    them into the affected cone, which is un-fixed, and ``_round`` /
    ``_round_shared`` with ``warm=True`` un-fix any fixed vertex the
    relax still improves.

  * the legacy single-source entry points ``run_sssp`` (segment),
    ``run_sssp_ell`` (B3 and B4) and ``run_sssp_traced``, eager segment
    rounds recording a per-round trace as host arrays;

  * the legacy frontier branch of ``_round`` (the bidirectional pair):
    each lane relaxes only the out-edges of its own compacted buffer
    ``f_idx`` [B, cap] through B1, one launch a lane, while inWeight_nf
    and the C-propagation stay dense; the lanes may run different graphs
    (a ``GraphStack``, whose taint seeds ``stack_taint_seeds`` computes).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.contracts import HOST_SYNC_OPS, contract
from repro_torch.core.graph import INF, Graph, GraphStack
from repro_torch.core.sssp import backends


@dataclasses.dataclass(frozen=True)
class SSSPConfig:
    rules: frozenset[str] = frozenset({"min", "pred", "in", "out", "lb"})
    label_correcting: bool = False   # SP4 relaxes all discovered edges
    c_prop_iters: int = 1            # Eqn-(1) applications per round
    max_rounds: int | None = None    # default n + 2
    use_pallas: bool = False         # selects the "pallas" backend in auto
    early_exit: bool = True          # targeted solves stop once the target
    #   is fixed and explored (no effect on untargeted solves)

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
    # --- legacy frontier carries (None outside _round's frontier branch) ---
    f_idx: torch.Tensor | None = None       # int32[B, cap], padding n
    f_cnt: torch.Tensor | None = None       # int32[B] true frontier sizes
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
    target: int | None = None          # the goal of a targeted solve
    edges_relaxed: int | None = None   # frontier backend only
    host_syncs: int | None = None      # device->host reads of the solve
    trace: list | None = None          # run_sssp_traced: one dict a round
    partial: bool = False              # early-exited: only fixed vertices
    #   carry exact distances (dist[target] always does); path_to(target)
    #   stays exact
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
        return self._read(t, torch.Tensor.tolist)

    def read_numpy(self, t: torch.Tensor) -> np.ndarray:
        """As ``read``, into a numpy array (for long vectors)."""
        return self._read(t, lambda x: x.cpu().numpy())

    def _read(self, t: torch.Tensor, how):
        self.count += 1
        if not t.is_cuda:
            return how(t)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return how(t)
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


def _compact_lanes(mask: torch.Tensor, cap: int):
    """Per-lane compaction of bool[B, n] ``mask``: ``(f_idx int32[B, cap],
    f_cnt int32[B])``, each lane's first ``cap`` True positions in
    increasing order (padding ``n``) and its true count; positions past
    ``cap`` land in a spare column and drop, as the reference's
    ``mode="drop"`` scatter.  One prefix count over the flattened lanes,
    each lane's made relative by the count before its row (a scan along
    a long last axis of few rows is far slower on the card)."""
    B, n = mask.shape
    flat = torch.cumsum(mask.reshape(-1), 0, dtype=torch.int32).view(B, n)
    before = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    csum = flat - before[:, None]
    at = torch.where(mask & (csum <= cap), csum - 1, cap).long()
    f_idx = torch.full((B, cap + 1), n, dtype=torch.int32,
                       device=mask.device)
    f_idx.scatter_(1, at, torch.arange(n, dtype=torch.int32,
                                       device=mask.device).expand(B, n))
    return f_idx[:, :cap].contiguous(), csum[:, -1].contiguous()


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

def _init_state(g: Graph | GraphStack, sources: torch.Tensor,
                C0: torch.Tensor | None = None,
                prims: backends.Primitives | None = None) -> SSSPState:
    """Cold state for int64[B] ``sources``: D = +inf but 0 at the source,
    nothing fixed, C = 0 or the seeds ``max(C0, 0)`` (float32[B, n];
    the caller vouches ``C0[b, v] <= d(source_b, v)``).  Prims with a
    single-lane ``relax_frontier`` also seed the legacy frontier carries:
    ``f_idx = [s, n, n, ...]``, ``f_cnt = 1``, ``edges = 0``."""
    B = sources.shape[0]
    dev = g.device
    D = torch.full((B, g.n), INF, dtype=torch.float32, device=dev)
    D.scatter_(1, sources[:, None], 0.0)
    fixed = torch.zeros((B, g.n), dtype=torch.bool, device=dev)
    C = (torch.zeros_like(D) if C0 is None
         else torch.clamp(C0.to(torch.float32), min=0.0))
    f_idx = f_cnt = edges = None
    if prims is not None and prims.relax_frontier is not None:
        f_idx = torch.full((B, prims.frontier_cap), g.n, dtype=torch.int32,
                           device=dev)
        f_idx[:, 0] = sources.to(torch.int32)
        f_cnt = torch.ones(B, dtype=torch.int32, device=dev)
        edges = torch.zeros(B, dtype=torch.int64, device=dev)
    return SSSPState(D=D, C=C, fixed=fixed,
                     explored=fixed,
                     round=torch.zeros(B, dtype=torch.int32, device=dev),
                     fixed_by=torch.zeros((B, 5), dtype=torch.int32,
                                          device=dev),
                     edges=edges, f_idx=f_idx, f_cnt=f_cnt)


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


def _cond(state: SSSPState, max_rounds: int,
          targets: torch.Tensor | None = None) -> torch.Tensor:
    """bool[B] keep-going predicate per lane: something is discovered but
    not fixed, or fixed but not yet explored, within the round cap.  With
    int64[B] ``targets`` (-1: untargeted lane) a lane also stops once its
    target is fixed and explored: later rounds cannot change its D."""
    active = (state.D < INF) & ~state.fixed
    pending = state.fixed & ~state.explored
    go = (active.any(dim=1) | pending.any(dim=1)) & (state.round
                                                     < max_rounds)
    if targets is not None:
        t = targets.clamp(min=0)[:, None]
        done = ((targets >= 0) & state.fixed.gather(1, t)[:, 0]
                & state.explored.gather(1, t)[:, 0])
        go = go & ~done
    return go


def _loop(g: Graph, cfg: SSSPConfig, state: SSSPState,
          prims: backends.Primitives, sync: SyncCounter, max_rounds: int,
          targets: torch.Tensor | None = None,
          warm: bool = False) -> SSSPState:
    """Dense rounds while any lane's ``_cond`` holds (one host read a
    round), finished lanes select-frozen."""
    go = _cond(state, max_rounds, targets)
    while sync.read(go.any()):
        state = _select(go, _round(g, cfg, state, prims, warm), state)
        go = _cond(state, max_rounds, targets)
    return state


# ---------------------------------------------------------------------------
# Warm start after a weight delta
# ---------------------------------------------------------------------------

def _delta_rows(g_old: Graph, delta):
    """(valid bool[k_pad], clamped int64 edge ids, old weights) of the
    delta's rows on ``g_old``; padding rows (``edge_idx >= e_pad``) are
    invalid and read a clamped edge that every caller masks out."""
    valid = delta.edge_idx < g_old.e_pad
    idx = delta.edge_idx.clamp(max=g_old.e_pad - 1).long()
    return valid, idx, g_old.w[idx]


def delta_taint_seeds(g_old: Graph, delta, D0: torch.Tensor):
    """Taint seeds of a warm start, per lane of ``D0`` float32[B, n] (the
    distances of the previous solves on ``g_old``):

      seeds bool[B, n]: heads v of delta edges (u, v) that increased and
          were tight, ``D0[u] + w_old <= D0[v]`` with both finite; only
          through such an edge can an old certificate break;
      pure_increase bool[B]: no delta edge decreased, so every old D is
          still a lower bound (the same for every lane).
    """
    n = g_old.n
    B = D0.shape[0]
    valid, idx, w_old = _delta_rows(g_old, delta)
    src, dst = g_old.src_l[idx], g_old.dst_l[idx]
    D0_ext = torch.cat([D0, D0.new_full((B, 1), INF)], dim=1)
    Ds, Dd = D0_ext[:, src], D0_ext[:, dst]
    increased = valid & (delta.new_w > w_old)
    tight = (Ds + w_old <= Dd) & (Ds < INF) & (Dd < INF)
    seed_at = torch.where(increased & tight, dst, n)
    seeds = torch.zeros((B, n + 1), dtype=torch.bool, device=D0.device)
    seeds.scatter_(1, seed_at, True)
    pure = ~(valid & (delta.new_w < w_old)).any()
    return seeds[:, :n].contiguous(), pure.expand(B)


def stack_taint_seeds(s_old: GraphStack, delta, D0: torch.Tensor):
    """``delta_taint_seeds`` over a ``GraphStack``: row m of the stacked
    ``delta`` (``edge_idx``/``new_w`` [M, k_pad]) is member m's, ``D0``
    float32[L, n] the lanes' previous distances on ``s_old``.  Returns
    ``seeds`` bool[L, n] and ``pure_increase`` bool[L] (per member)."""
    M, P, n = s_old.size, s_old.per, s_old.n
    k = delta.edge_idx.shape[1]
    valid = delta.edge_idx < s_old.e_pad                     # [M, k]
    idx = delta.edge_idx.clamp(max=s_old.e_pad - 1).long()
    w_old = s_old.w.gather(1, idx)
    src = s_old.src_ix[:, 0].gather(1, idx)[:, None].expand(M, P, k)
    dst = s_old.dst_ix[:, 0].gather(1, idx)[:, None].expand(M, P, k)
    D0_ext = torch.cat([D0, D0.new_full((D0.shape[0], 1), INF)],
                       dim=1).view(M, P, n + 1)
    Ds, Dd = D0_ext.gather(2, src), D0_ext.gather(2, dst)
    increased = (valid & (delta.new_w > w_old))[:, None]
    tight = (Ds + w_old[:, None] <= Dd) & (Ds < INF) & (Dd < INF)
    seed_at = torch.where(increased & tight, dst, n)
    seeds = torch.zeros((M, P, n + 1), dtype=torch.bool, device=D0.device)
    seeds.scatter_(2, seed_at, True)
    pure = ~(valid & (delta.new_w < w_old)).any(dim=1)
    return (seeds[..., :n].reshape(M * P, n),
            pure.repeat_interleave(P))


def delta_decrease_sources(g_old: Graph, delta) -> torch.Tensor:
    """bool[n]: tails of decreased delta edges, the fixed vertices whose
    offers changed without their own D changing (lane-independent)."""
    n = g_old.n
    valid, idx, w_old = _delta_rows(g_old, delta)
    at = torch.where(valid & (delta.new_w < w_old), g_old.src_l[idx], n)
    out = torch.zeros(n + 1, dtype=torch.bool, device=g_old.device)
    return out.index_fill_(0, at, True)[:n]


def _warm_seed_mask(g: Graph, taint: torch.Tensor, fixed: torch.Tensor,
                    D: torch.Tensor,
                    dec_src: torch.Tensor | None) -> torch.Tensor:
    """bool[B, n]: fixed vertices whose warm round-1 offers are not yet
    folded into the warm state: the cone's in-boundary (fixed tails of
    edges into ``taint``) and ``dec_src``; every surviving fixed vertex
    when ``dec_src`` is None (still exact)."""
    if dec_src is None:
        return fixed & (D < INF)
    B, n = taint.shape
    at = torch.where(g.gather_dst(taint, fill=False), g.src_l, n)
    bnd = torch.zeros((B, n + 1), dtype=torch.bool, device=taint.device)
    bnd.scatter_(1, at, True)
    return (bnd[:, :n] | dec_src) & fixed & (D < INF)


def _init_state_warm(g: Graph, prev_D: torch.Tensor,
                     prev_fixed: torch.Tensor, seeds: torch.Tensor,
                     pure_increase: torch.Tensor,
                     prims: backends.Primitives, sync: SyncCounter):
    """Warm state of B lanes after a weight delta, on the mutated ``g``.

    The affected cone ``taint`` grows from ``seeds`` along tight edges
    (``prims.relax(prev_D, taint) <= prev_D``) to a fixpoint, one relax
    a sweep and one host read a sweep; a lane whose cone stopped growing
    is frozen, so ``sweeps`` int32[B] is per lane.  The cone is un-fixed
    with D = +inf (its old bounds may be too low); the rest keeps its D
    and stays fixed.  C is D where fixed, and under a pure increase the
    old D elsewhere (still a lower bound), else 0.  ``explored`` starts
    all False, so the first round relaxes every fixed vertex.  Returns
    ``(state, sweeps, taint)``.
    """
    B, n = prev_D.shape
    dev = prev_D.device
    live = prev_D < INF
    taint = seeds
    changed = seeds.any(dim=1)
    sweeps = torch.zeros(B, dtype=torch.int32, device=dev)
    go = changed & (sweeps < n + 1)
    while sync.read(go.any()):
        reach = prims.relax(prev_D, taint)
        taint2 = taint | ((reach <= prev_D) & live)
        grew = (taint2 != taint).any(dim=1)
        taint = torch.where(go[:, None], taint2, taint)
        changed = torch.where(go, grew, changed)
        sweeps = sweeps + go.to(torch.int32)
        go = changed & (sweeps < n + 1)
    fixed = prev_fixed & ~taint
    D = torch.where(taint, INF, prev_D)
    C = torch.where(fixed, D, torch.where(
        pure_increase[:, None] & prev_fixed & live, prev_D, 0.0))
    state = SSSPState(
        D=D, C=C, fixed=fixed, explored=torch.zeros_like(fixed),
        round=torch.zeros(B, dtype=torch.int32, device=dev),
        fixed_by=torch.zeros((B, 5), dtype=torch.int32, device=dev))
    return state, sweeps, taint


def _solve_warm(g: Graph, cfg: SSSPConfig, prev_D: torch.Tensor,
                prev_fixed: torch.Tensor, seeds: torch.Tensor,
                pure_increase: torch.Tensor, prims: backends.Primitives,
                sync: SyncCounter, dec_src: torch.Tensor | None = None):
    """Warm re-solve of B lanes to fixpoint on the mutated ``g``: the
    warm state, then ``warm=True`` rounds.  The round cap is doubled
    against a cold solve, since un-fixing can re-open vertices.  Frontier
    prims route to ``_solve_warm_frontier``.  Returns ``(state, sweeps,
    taint)``."""
    if prims.relax_frontier_b is not None:
        return _solve_warm_frontier(g, cfg, prev_D, prev_fixed, seeds,
                                    pure_increase, prims, sync, dec_src)
    state, sweeps, taint = _init_state_warm(g, prev_D, prev_fixed, seeds,
                                            pure_increase, prims, sync)
    max_rounds = 2 * cfg.max_rounds if cfg.max_rounds else 2 * g.n + 4
    state = _loop(g, cfg, state, prims, sync, max_rounds, warm=True)
    return state, sweeps, taint


# ---------------------------------------------------------------------------
# Dense round
# ---------------------------------------------------------------------------

@contract(
    "engine.round_body",
    routes=("*",),
    forbid=HOST_SYNC_OPS,
    forbid_hot=("aten.sort", "aten.topk"),
    read_budget={"*": 1, "frontier.*": 3, "fleet_frontier.*": 3},
    notes="The round body reads the host only through SyncCounter: no "
          "uncounted read (.item(), bool(), a boolean-mask index, a "
          "device-to-host copy) anywhere in a route, no sort inside a "
          "round (masked min-reductions only), 32-bit values "
          "(allow_wide_dtypes defaults False).  A dense round reads the "
          "host once (the loop's predicate); a frontier round three "
          "times (the predicate with the frontier count, the two cone "
          "counts, the inWeight_nf walk count), one more for each "
          "C-propagation pass past the first (c_prop_iters 1 on every "
          "probe route).")
def _round(g: Graph | GraphStack, cfg: SSSPConfig, state: SSSPState,
           prims: backends.Primitives, warm: bool = False) -> SSSPState:
    """One bulk-synchronous dense round over ``[B, n]`` lanes — THE round
    body of the segment and ELL/pallas backends.  ``warm=True`` un-fixes
    every fixed vertex the relax improves (possible only after a weight
    decrease) and drops its C to 0; D stays monotone, so this ends.

    With a single-lane ``prims.relax_frontier`` and the state's frontier
    carries (``_init_state(..., prims)``), step 1 relaxes only each lane's
    buffer ``f_idx`` (the reference's legacy frontier branch): repeated
    offers are value-identical and min-folded, so this is bitwise the
    dense relax.  A lane whose count outgrew ``cap < n`` takes the dense
    relax that round, as the reference's ``lax.cond`` does lane by lane
    under vmap.  ``edges`` meters the out-degrees of the live buffer
    slots (``e_pad`` on a dense round), and the end of the round
    compacts the next buffer from the vertices whose offers are new.
    Prims with ``relax2`` (the distributed backend) take the dense relax
    and inWeight_nf from one fused call."""
    D, C, fixed = state.D, state.C, state.fixed
    use_frontier = (prims.relax_frontier is not None
                    and state.f_idx is not None)

    # --- Step 1: relax FIRST, from previously-fixed (label-setting) or
    # all discovered (label-correcting) sources.
    relax_src = (D < INF) if cfg.label_correcting else fixed
    need_inw = ("in" in cfg.rules) or ("pred" in cfg.rules)
    edges = state.edges
    if use_frontier:
        B, n = D.shape
        f_idx = state.f_idx
        D_relax = prims.relax_frontier(D, f_idx, relax_src)
        u = f_idx.clamp(max=n - 1).long()
        live = (f_idx < n) & relax_src.gather(1, u)
        sparse = torch.where(live, g.out_deg.expand(B, n).gather(1, u),
                             0).sum(dim=1, dtype=torch.int64)
        if prims.frontier_cap < n:
            overflow = state.f_cnt > prims.frontier_cap
            D_relax = torch.where(overflow[:, None],
                                  prims.relax(D, relax_src), D_relax)
            sparse = torch.where(overflow, g.e_pad, sparse)
        edges = edges + sparse
        in_w_nf = prims.in_weight_nf(~fixed) if need_inw else None
    elif need_inw and prims.relax2 is not None:
        D_relax, in_w_nf = prims.relax2(D, relax_src, ~fixed)
    else:
        D_relax = prims.relax(D, relax_src)
        in_w_nf = prims.in_weight_nf(~fixed) if need_inw else None
    if warm:
        improved = fixed & (D_relax < D)
        fixed = fixed & ~improved
        C = torch.where(improved, 0.0, C)
    D = torch.where(~fixed, torch.minimum(D, D_relax), D)
    explored = fixed

    discovered = D < INF
    active = discovered & ~fixed

    # --- Step 2: the heap minimum of SP1–SP3 and the out-rule threshold
    # (one call), then the fixing rules.
    mins = prims.masked_min_pair(
        D, active, g.out_weight if "out" in cfg.rules else None)
    minD = mins[:, :1]
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
        new_fix = new_fix | count(active & (D <= mins[:, 1:]))
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

    f_idx, f_cnt = state.f_idx, state.f_cnt
    if use_frontier:
        # new offers come from D changes (label-correcting) or from fix
        # events, a warm unfix-refix included (label-setting)
        if cfg.label_correcting:
            fresh = D != state.D
        else:
            fresh = fixed2 & (~state.fixed | (D != state.D))
        f_idx, f_cnt = _compact_lanes(fresh, prims.frontier_cap)
    return SSSPState(
        D=D, C=C, fixed=fixed2, explored=explored, round=state.round + 1,
        fixed_by=state.fixed_by + torch.stack(rule_counts, dim=1),
        edges=edges, f_idx=f_idx, f_cnt=f_cnt)


def _solve(g: Graph, cfg: SSSPConfig, sources: torch.Tensor,
           prims: backends.Primitives, sync: SyncCounter,
           C0: torch.Tensor | None = None,
           targets: torch.Tensor | None = None) -> SSSPState:
    """Dense solve of int64[B] ``sources`` to fixpoint, or per lane to
    its target (int64[B], -1: none; ignored without ``cfg.early_exit``),
    from lower-bound seeds ``C0`` float32[B, n] if given.  Frontier prims
    route to ``_solve_frontier`` (as the reference's ``_solve`` does for
    every frontier solve, B = 1 included)."""
    if not cfg.early_exit:
        targets = None
    if prims.relax_frontier_b is not None:
        return _solve_frontier(g, cfg, sources, prims, sync, C0, targets)
    return _loop(g, cfg, _init_state(g, sources, C0), prims, sync,
                 cfg.max_rounds or g.n + 2, targets)


# ---------------------------------------------------------------------------
# Legacy single-source entry points
# ---------------------------------------------------------------------------

def _source_tensor(g: Graph, source: int) -> torch.Tensor:
    """int64[1] on ``g``'s device, made by a fill (no host copy)."""
    if not 0 <= int(source) < g.n:
        raise ValueError(f"source vertex {source} out of range [0, {g.n})")
    return torch.full((1,), int(source), dtype=torch.int64, device=g.device)


def _run_one(g: Graph, cfg: SSSPConfig, source: int,
             prims: backends.Primitives) -> SSSPResult:
    sync = SyncCounter()
    state = _solve(g, cfg, _source_tensor(g, source), prims, sync)
    meta = sync.read(torch.cat([state.round, state.fixed_by[0]]))
    return SSSPResult(
        dist=state.D[0], C=state.C[0], fixed=state.fixed[0],
        rounds=int(meta[0]), fixed_by=_fixed_by_dict(meta[1:]),
        source=int(source), graph=g, host_syncs=sync.count)


def run_sssp(g: Graph, source: int = 0,
             cfg: SSSPConfig = SP4_CONFIG) -> SSSPResult:
    """One source through the dense segment round (B = 1).  Compatibility
    entry point: ``Solver`` keeps the layouts across sources and batches
    them."""
    return _run_one(g, cfg, source, backends.segment_prims(g))


def run_sssp_ell(g: Graph, ell, source: int = 0,
                 cfg: SSSPConfig = SP4_CONFIG) -> SSSPResult:
    """One source through the ELL round: every relax, inWeight_nf and
    Eqn-(1) reduction one call of the fused relax (B3, three a round
    under SP4), both minima one masked-min pair (B4) — the kernels on
    the card, their plain versions on the CPU."""
    return _run_one(g, cfg, source, backends.ell_prims(g, ell))


def run_sssp_traced(g: Graph, source: int = 0,
                    cfg: SSSPConfig = SP4_CONFIG,
                    max_rounds: int | None = None) -> SSSPResult:
    """Eager segment rounds at B = 1 recording a per-round trace: one dict
    a round with the reference's keys (``round``, ``n_fixed``,
    ``fixed_by_round``, ``minD``, and ``D``/``C`` after and
    ``prev_D``/``prev_C`` before the round as numpy arrays), for the
    bounds invariants C <= cost <= D, C rising and D falling.  It reads
    the host every round by design, three reads a round (the predicate,
    D with C, the fixed mask with the counts), all in ``host_syncs``."""
    n = g.n
    prims = backends.segment_prims(g)
    sync = SyncCounter()
    state = _init_state(g, _source_tensor(g, source))
    limit = max_rounds or cfg.max_rounds or n + 1
    D, C = sync.read_numpy(torch.stack([state.D[0], state.C[0]]))
    prev_fb = np.zeros(5, np.int64)
    trace = []
    while sync.read(_cond(state, limit)[0]):
        state = _round(g, cfg, state, prims)
        prev_D, prev_C = D, C
        D, C = sync.read_numpy(torch.stack([state.D[0], state.C[0]]))
        ints = sync.read_numpy(torch.cat([state.fixed[0].to(torch.int32),
                                          state.fixed_by[0], state.round]))
        fixed, fb = ints[:n].astype(bool), ints[n:n + 5].astype(np.int64)
        trace.append(dict(
            round=int(ints[n + 5]),
            n_fixed=int(fixed.sum()),
            fixed_by_round={r: int(c) for r, c in
                            zip(_RULE_ORDER, fb - prev_fb)},
            minD=float(np.min(np.where(~fixed & (prev_D < np.inf), prev_D,
                                       np.inf), initial=np.inf)),
            D=D, C=C, prev_D=prev_D, prev_C=prev_C))
        prev_fb = fb
    return SSSPResult(
        dist=state.D[0], C=state.C[0], fixed=state.fixed[0],
        rounds=trace[-1]["round"] if trace else 0,
        fixed_by=_fixed_by_dict(prev_fb), trace=trace, source=int(source),
        graph=g, host_syncs=sync.count)


# ---------------------------------------------------------------------------
# Shared-batch-frontier round
# ---------------------------------------------------------------------------

def _round_shared(g: Graph, cfg: SSSPConfig, state: SSSPState,
                  f_idx: torch.Tensor, f_cnt: int,
                  prims: backends.Primitives, sync: SyncCounter,
                  warm: bool = False):
    """One round over ``[B, n]`` lanes sharing ONE compacted union
    frontier ``f_idx`` (``f_cnt`` its true size, already on the host).

    Same rules and order as ``_round``; only the execution differs:
    step 1 gathers the shared buffer once and scatter-mins per lane (B2),
    falling back to the dense relax when ``f_cnt > cap``; inWeight_nf is
    the incremental carry ``state.in_w_nf``; C-propagation is bounded to
    the cone of flipped-bit sources and sources with ``C > minD``, with
    the closed form ``max(C, min(c_fix, minD + inWeight_nf))`` off it.
    ``warm=True`` un-fixes improved vertices as ``_round`` does and marks
    them c_fix-stale (they leave the fixed-source set).  Returns
    ``(state, fresh)`` with ``fresh`` bool[B, n] the next-round frontier
    mask.
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
    if warm:
        improved = fixed & (D_relax < D)
        fixed = fixed & ~improved
        C = torch.where(improved, 0.0, C)
        if cfix_stale is not None:
            cfix_stale = cfix_stale | improved
    D = torch.where(~fixed, torch.minimum(D, D_relax), D)
    explored = fixed

    discovered = D < INF
    active = discovered & ~fixed

    # --- Step 2: per-lane reductions (one call) + fixing rules --------
    mins = prims.masked_min_pair(
        D, active, g.out_weight if "out" in cfg.rules else None)
    minD = mins[:, :1]
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
        new_fix = new_fix | count(active & (D <= mins[:, 1:]))
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
                       sync: SyncCounter,
                       targets: torch.Tensor | None = None,
                       warm: bool = False) -> SSSPState:
    """Shared-frontier loop over ``[B, n]`` lanes: one union compaction
    per round; run while any lane's ``_cond`` (with its target test)
    holds and select-freeze the finished lanes.  The termination
    predicate and the frontier count (which picks the overflow branch)
    come back in one host read."""
    cap = prims.frontier_cap
    go = _cond(state, max_rounds, targets)
    while True:
        more, cnt = sync.read(torch.stack([go.any().to(torch.int32),
                                           f_cnt.to(torch.int32)]))
        if not more:
            return state
        st2, fresh = _round_shared(g, cfg, state, f_idx, cnt, prims, sync,
                                   warm)
        state = _select(go, st2, state)
        union = (fresh & go[:, None]).any(dim=0)
        f_idx, f_cnt = _compact_frontier(union, cap, g.n)
        go = _cond(state, max_rounds, targets)


def _solve_frontier(g: Graph, cfg: SSSPConfig, sources: torch.Tensor,
                    prims: backends.Primitives, sync: SyncCounter,
                    C0: torch.Tensor | None = None,
                    targets: torch.Tensor | None = None) -> SSSPState:
    """Batched frontier solve of int64[B] ``sources``: B lanes, ONE shared
    union frontier seeded with the union of the sources."""
    state = _attach_carries(g, cfg, prims, _init_state(g, sources, C0))
    src_mask = torch.zeros(g.n, dtype=torch.bool, device=g.device)
    src_mask.index_fill_(0, sources, True)
    f_idx, f_cnt = _compact_frontier(src_mask, prims.frontier_cap, g.n)
    max_rounds = cfg.max_rounds or g.n + 2
    state = _frontier_fixpoint(g, cfg, prims, state, f_idx, f_cnt,
                               max_rounds, sync, targets)
    return _strip_carries(state)


def _solve_warm_frontier(g: Graph, cfg: SSSPConfig, prev_D: torch.Tensor,
                         prev_fixed: torch.Tensor, seeds: torch.Tensor,
                         pure_increase: torch.Tensor,
                         prims: backends.Primitives, sync: SyncCounter,
                         dec_src: torch.Tensor | None = None):
    """Batched warm re-solve on the shared union frontier.  The lanes'
    warm states come from ``_init_state_warm`` with segment taint sweeps
    (as the reference's, whatever the route); the shared buffer is the
    union of the lanes' ``_warm_seed_mask``s, a superset of each lane's
    seeds whose extra vertices only re-send folded offers.  Returns
    ``(state, sweeps int32[B], taint bool[B, n])``."""
    state, sweeps, taint = _init_state_warm(
        g, prev_D, prev_fixed, seeds, pure_increase,
        backends.segment_prims(g), sync)
    state = _attach_carries(g, cfg, prims, state)
    seed = _warm_seed_mask(g, taint, state.fixed, state.D, dec_src)
    f_idx, f_cnt = _compact_frontier(seed.any(dim=0), prims.frontier_cap,
                                     g.n)
    max_rounds = 2 * cfg.max_rounds if cfg.max_rounds else 2 * g.n + 4
    state = _frontier_fixpoint(g, cfg, prims, state, f_idx, f_cnt,
                               max_rounds, sync, warm=True)
    return _strip_carries(state), sweeps, taint
