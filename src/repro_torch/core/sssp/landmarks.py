"""Landmark (ALT) lower-bound seeds for targeted queries (port of
``repro/core/sssp/landmarks.py``).

Exact distance tables from and to a few well-spread landmarks L turn the
triangle inequality into lower bounds on d(s, ·) for any source s:

    C0[v] = max(0, max_L(d(L, v) - d(L, s)), max_L(d(s, L) - d(v, L)))

which ``Solver.solve(s, target=t, C0=...)`` feeds to the lb rule, so a
targeted solve certifies its target rounds earlier.  ``d(L, ·)`` rows are
solves of a forward ``DynamicSolver``, ``d(·, L)`` rows solves on the
transpose graph (``Graph.reverse()``) by a private reverse one, and the
landmarks are picked farthest-point by the same solver.

The tables are k more tracked sources: ``LandmarkIndex.apply_delta``
routes a ``GraphDelta`` through both solvers (the reverse one through
the delta remapped by the forward->reverse edge permutation) and
warm-refreshes them.  With ``refresh=False`` the tables go stale; they
stay valid lower bounds while every delta since the last refresh only
increased weights, and the first decrease turns seeding off
(``seed_ok``) until ``refresh``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import Graph, HostGraph, resolve_device
from repro_torch.core.sssp.dynamic import DynamicSolver, GraphDelta, make_delta
from repro_torch.core.sssp.engine import SP4_CONFIG, SSSPConfig, SyncCounter

INF = float("inf")


def seed_lower_bounds(d_from: torch.Tensor, d_to: torch.Tensor,
                      sources) -> torch.Tensor:
    """ALT seeds from the [k, n] tables ``d_from[L, v] = d(L, v)`` and
    ``d_to[L, v] = d(v, L)``: float32[n] for an int ``sources``,
    float32[B, n] for a sequence or int tensor of B sources.

    A +inf entry is information: ``d(L, v) = inf`` with ``d(L, s)``
    finite proves v unreachable from s.  Only inf - inf (NaN) carries
    none, and it becomes -inf before the max.
    """
    one = np.ndim(sources) == 0
    idx = torch.as_tensor([sources] if one else sources, dtype=torch.int64)
    if d_from.is_cuda:     # an async copy from pinned memory: no host sync
        idx = idx.pin_memory().to(d_from.device, non_blocking=True)
    ds = d_from.index_select(1, idx).T[:, :, None]   # [B, k, 1] d(L, s)
    ts = d_to.index_select(1, idx).T[:, :, None]     # [B, k, 1] d(s, L)
    fwd = d_from[None] - ds                          # d(L, v) - d(L, s)
    bwd = ts - d_to[None]                            # d(s, L) - d(v, L)
    fwd = torch.where(torch.isnan(fwd), -INF, fwd)
    bwd = torch.where(torch.isnan(bwd), -INF, bwd)
    best = torch.maximum(fwd, bwd).amax(dim=1).clamp(min=0.0)
    return best[0] if one else best


def select_landmarks(solver, k: int, *, seed: int = 0,
                     first: int | None = None) -> np.ndarray:
    """Farthest-point landmarks: start at ``first`` (default random), then
    add the vertex farthest (finite distances only) from its nearest
    chosen landmark; if nothing reachable is left, a random unused
    vertex.  k solves of ``solver``."""
    n = solver.graph.n
    k = max(1, min(int(k), n))
    rng = np.random.default_rng(seed)
    lms = [int(first) if first is not None else int(rng.integers(n))]

    def dist(s):
        return solver.solve(s).dist.cpu().numpy().astype(np.float64)

    d_min = dist(lms[0])
    while len(lms) < k:
        cand = np.where(np.isfinite(d_min), d_min, -1.0)
        cand[np.asarray(lms)] = -1.0
        nxt = int(np.argmax(cand))
        if cand[nxt] <= 0.0:
            unused = np.setdiff1d(np.arange(n), np.asarray(lms))
            if unused.size == 0:
                break
            nxt = int(rng.choice(unused))
        lms.append(nxt)
        d_min = np.minimum(d_min, dist(nxt))
    return np.asarray(lms, np.int32)


@dataclasses.dataclass(frozen=True)
class ReselectPolicy:
    """When to act on ``LandmarkIndex.needs_reselect``: mean seed
    tightness below ``threshold``, at least ``min_observations`` ratios
    since the last reselect (hysteresis), and at least
    ``cooldown_deltas`` deltas since it (cadence)."""

    threshold: float = 0.5
    min_observations: int = 32
    cooldown_deltas: int = 1


class LandmarkIndex:
    """Landmark distance tables and seeded lower bounds over one graph.

    graph:   ``Graph`` or ``HostGraph`` (placed on ``device``).
    k:       number of landmarks (two [k, n] tables on the device).
    solver:  an optional shared forward ``DynamicSolver`` (the serving
             layer's): the landmark rows are then its tracked sources.
             Else the index owns one.
    cfg/backend/seed: engine config, backend and selection RNG seed of
             the owned solvers.
    group:   the process group of the owned solvers' distributed backend.

    ``seed``/``seed_batch`` return ``C0`` for ``Solver.solve(s,
    target=t, C0=...)`` on the index's device, or None when stale tables
    can no longer vouch for their bounds.
    """

    def __init__(self, graph, k: int = 8, *, cfg: SSSPConfig = SP4_CONFIG,
                 backend: str = "segment", seed: int = 0,
                 solver: DynamicSolver | None = None, device=None,
                 group=None):
        if isinstance(graph, HostGraph):
            graph = graph.to_device(resolve_device(device))
        if not isinstance(graph, Graph):
            raise TypeError(f"graph must be Graph/HostGraph, "
                            f"got {type(graph)!r}")
        if device is not None:
            graph = graph.to(resolve_device(device))
        self.k = max(1, min(int(k), graph.n))
        self._shared = solver is not None
        self._fwd = solver if solver is not None else DynamicSolver(
            graph, cfg, backend, device=graph.device, group=group)
        self._rev = DynamicSolver(graph.reverse(), cfg, backend,
                                  device=graph.device, group=group)
        # forward edge i sits at row rev_perm[i] of the reverse edge list
        # (reverse() re-sorts stably by the new dst, the forward src)
        e = graph.e
        order = np.argsort(graph.src[:e].cpu().numpy(), kind="stable")
        self._rev_perm = np.empty(e, np.int64)
        self._rev_perm[order] = np.arange(e)
        self.d_from: torch.Tensor | None = None   # float32[k, n] d(L, v)
        self.d_to: torch.Tensor | None = None     # float32[k, n] d(v, L)
        self.stale = False
        self.seed_ok = True
        self._host_tables = None
        self._tight_sum = 0.0      # seed tightness C0[t] / dist[t]
        self._tight_cnt = 0
        self._select_seed = int(seed)
        self.deltas_applied = 0
        self.reselects = 0
        self._deltas_at_reselect = 0
        self.landmarks = select_landmarks(self._fwd, self.k, seed=seed)
        self.refresh()

    # ------------------------------------------------------------------
    def refresh(self) -> None:
        """Recompute both tables on the solvers' current graphs (tracked
        rows that are current are served without a new solve)."""
        lms = [int(v) for v in self.landmarks]
        self.d_from = self._fwd.resolve(lms).dist
        self.d_to = self._rev.resolve(lms).dist
        self.stale = False
        self.seed_ok = True

    def seed(self, source: int) -> torch.Tensor | None:
        """C0 float32[n] for one source (None: seeding unsound)."""
        if not self.seed_ok:
            return None
        return seed_lower_bounds(self.d_from, self.d_to, int(source))

    def seed_batch(self, sources) -> torch.Tensor | None:
        """C0 float32[B, n] for a batch of sources (None: unsound)."""
        if not self.seed_ok:
            return None
        return seed_lower_bounds(self.d_from, self.d_to,
                                 np.asarray(sources, np.int64).ravel())

    def seed_pair(self, source: int, target: int) -> torch.Tensor | None:
        """float32[2, n]: row 0 bounds d(source, ·), row 1 d(·, target),
        the same bound with the tables swapped (None: unsound)."""
        if not self.seed_ok:
            return None
        return torch.stack([
            seed_lower_bounds(self.d_from, self.d_to, int(source)),
            seed_lower_bounds(self.d_to, self.d_from, int(target))])

    def estimate_pairs(self, pairs) -> np.ndarray | None:
        """float64[B] seeded lower bound ``C0[t]`` per (source, target),
        computed on the host from the table columns.  The host copy of
        the tables (one counted read of both) is cached against the
        identity of the live ``d_from``,
        so any swap of the tables invalidates it.  None when the tables
        cannot vouch (as ``seed``)."""
        if not self.seed_ok or not len(pairs):
            return None
        s = np.asarray([p[0] for p in pairs], np.int64)
        t = np.asarray([p[1] for p in pairs], np.int64)
        if self._host_tables is None or self._host_tables[0] is not self.d_from:
            both = SyncCounter().read_numpy(torch.stack([self.d_from,
                                                         self.d_to]))
            self._host_tables = (self.d_from, both[0].astype(np.float64),
                                 both[1].astype(np.float64))
        df, dt = self._host_tables[1:]
        with np.errstate(invalid="ignore"):
            fwd = df[:, t] - df[:, s]
            bwd = dt[:, s] - dt[:, t]
        fwd = np.where(np.isnan(fwd), -np.inf, fwd)
        bwd = np.where(np.isnan(bwd), -np.inf, bwd)
        return np.maximum(np.maximum(fwd, bwd).max(axis=0), 0.0)

    # ------------------------------------------------------------------
    def record_tightness(self, ratios) -> None:
        """Accumulate observed ``C0[target] / dist[target]`` ratios (finite
        ones only): 1.0 is an exact seed, toward 0 the landmarks stopped
        explaining the metric."""
        ratios = np.asarray(ratios, np.float64).ravel()
        ratios = ratios[np.isfinite(ratios)]
        if ratios.size:
            self._tight_sum += float(ratios.sum())
            self._tight_cnt += int(ratios.size)

    def tightness(self) -> float | None:
        """Mean observed seed tightness (None before any observation)."""
        if not self._tight_cnt:
            return None
        return self._tight_sum / self._tight_cnt

    @property
    def tightness_count(self) -> int:
        return self._tight_cnt

    def needs_reselect(self, threshold: float = 0.5) -> bool:
        """Mean tightness below ``threshold`` (never without observations
        or while seeding is off)."""
        m = self.tightness()
        return bool(self.seed_ok and m is not None and m < float(threshold))

    def reset_tightness(self) -> None:
        self._tight_sum = 0.0
        self._tight_cnt = 0

    def reselect(self, *, seed: int | None = None) -> np.ndarray:
        """Farthest-point selection again on the current graph (tracked
        solves of the forward solver, so ``refresh`` reuses them), new
        tables, tightness reset; returns the new landmarks."""
        self.reselects += 1
        self._deltas_at_reselect = self.deltas_applied
        sel_seed = (self._select_seed + 7919 * self.reselects
                    if seed is None else int(seed))
        self.landmarks = select_landmarks(self._fwd, self.k, seed=sel_seed)
        self.refresh()
        self.reset_tightness()
        return self.landmarks

    def maybe_reselect(self, policy: ReselectPolicy | float) -> bool:
        """``reselect`` if the policy (a float: its threshold) fires."""
        if not isinstance(policy, ReselectPolicy):
            policy = ReselectPolicy(threshold=float(policy))
        if self._tight_cnt < policy.min_observations:
            return False
        if (self.deltas_applied - self._deltas_at_reselect
                < policy.cooldown_deltas):
            return False
        if not self.needs_reselect(policy.threshold):
            return False
        self.reselect()
        return True

    # ------------------------------------------------------------------
    def reverse_delta(self, delta: GraphDelta) -> GraphDelta:
        """The same weight updates as a delta on the transpose graph."""
        k = delta.k
        idx = delta.edge_idx[:k].cpu().numpy().astype(np.int64)
        w = delta.new_w[:k].cpu().numpy()
        return make_delta(self._rev.graph, self._rev_perm[idx], w)

    def apply_delta(self, delta: GraphDelta, *,
                    refresh: bool = True) -> dict:
        """Keep the index coherent with a forward-graph weight delta.

        Shared mode: call after the owning solver's ``update``.  Owned
        mode: the forward solver is updated here too.  The reverse solver
        always is, through the remapped delta.  ``refresh=False`` defers
        the tables (stale; seeding stays on only while no delta since the
        last refresh decreased a weight).  Returns the reverse solver's
        update stats.
        """
        self.deltas_applied += 1
        want = [int(v) for v in self.landmarks] if refresh else []
        rev_stats = self._rev.update(self.reverse_delta(delta), refresh=want)
        if not self._shared:
            self._fwd.update(delta, refresh=want)
        if refresh:
            self.refresh()
        else:
            self.stale = True
            if rev_stats["decreased"]:
                self.seed_ok = False
        return rev_stats
