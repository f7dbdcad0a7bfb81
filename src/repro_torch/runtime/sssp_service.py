"""SSSP query service: continuous batching over a Solver (port of
``repro/runtime/sssp_service.py``, the same routes, caches and stats).

Incoming ``(source, target)`` queries are coalesced by source,
deduplicated against an LRU cache of solved sources, and the misses are
batched into ``Solver.solve_batch`` calls: one engine run answers up to
``batch`` sources at once, and every query against an already-solved
source is a dictionary lookup.

The service runs on a :class:`~repro_torch.core.sssp.dynamic.DynamicSolver`,
so the graph may change mid-flight: ``apply_delta`` applies a weight
delta, warm-refreshes the hottest sources through the incremental
re-solve, and version-stamps the cache so every other entry goes stale
at once (a stale hit is a miss, re-solved on demand).

Goal-directed serving (``landmarks=``/``p2p=``): a ``Query(target=t)``
takes the targeted path (``solve_batch(..., targets=...)``), each lane
stopping once its own target is fixed, with lower bounds seeded from a
:class:`~repro_torch.core.sssp.landmarks.LandmarkIndex`.  Those partial
results enter the cache stamped ``partial=True``: they answer later
queries only for vertices their ``fixed`` mask certifies exact, and never
a full-vector lookup.

Query-engine v2 (``planner=`` / ``bidirectional=`` / ``reselect=``): a
:class:`~repro_torch.runtime.planner.WavePlanner` routes each wave's
misses to a full batched solve, bidirectional solves or est-sorted
power-of-two targeted waves.  Bidirectional answers land in a
version-stamped ``(source, target)`` pair cache that keeps each answer's
two device lanes, so ``apply_delta`` re-solves hot pairs warm, and a
:class:`ReselectPolicy` re-selects landmarks when seed tightness drifts.

Answers leave the service as host values, as in the reference:
``Query.distance`` a float, ``Query.path`` a list, ``Query.dist`` a
numpy array.  Device reads are gathered: one read for a wave's partial
cache probes, one for its scalar answers, one for its full vectors, one
for the tightness telemetry of a targeted batch and one per 8 result
rows of parent pointers.  The service's own reads go through a
``SyncCounter`` (``host_reads``), and the timers end with a synchronize
of the solver's device, not with a copy.  Its ``@contract`` names the
solver routes it rides (``analysis/check.py`` checks the composition).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core.sssp.bidirectional import BidirectionalSolver
from repro_torch.core.sssp.dynamic import DynamicSolver, GraphDelta
from repro_torch.core.sssp.engine import (SP4_CONFIG, SSSPConfig,
                                          SSSPResult, SyncCounter)
from repro_torch.core.sssp.landmarks import LandmarkIndex, ReselectPolicy
from repro_torch.core.sssp.parents import parent_pointers
from repro_torch.runtime.planner import WavePlan, WavePlanner

_PARENT_ROWS = 8    # result rows a parent-pointer pass (and read) takes


@dataclasses.dataclass
class Query:
    """One shortest-path request; answered in place by the service.

    ``target=None`` asks for the whole distance vector: the service
    attaches it as ``dist`` (float array over vertices) and leaves the
    scalar ``distance``/``path`` fields None.
    """

    source: int
    target: int | None = None     # None: whole distance vector wanted
    distance: float | None = None
    path: list[int] | None = None
    dist: np.ndarray | None = None  # filled for target=None queries
    done: bool = False


@contract(
    "service.rides_solver_routes",
    routes=(),
    composes=("segment.*", "*.targeted", "bidi.pair", "*.warm"),
    notes="The service runs no rounds of its own: every wave the "
          "planner emits runs a solver route (batched cold solves, "
          "targeted waves, bidirectional pair solves, warm refresh after "
          "apply_delta).  The gate checks composition: each of these "
          "route families must exist and must not FAIL.")
class SSSPService:
    """Continuous-batching SSSP server over one (mutable-weight) graph.

    Parameters mirror :class:`Solver` (``device=``, CUDA unless given,
    and the distributed backend's ``group=`` among ``solver_kw``);
    ``batch`` is the number of source slots per solve,
    ``cache_sources`` bounds the LRU of solved sources.

    ``landmarks``: ``int k`` builds a k-landmark :class:`LandmarkIndex`
    sharing this service's DynamicSolver, a pre-built index is used
    as-is, ``None`` disables seeding.  ``p2p``: route ``Query(target=t)``
    through targeted solves (default: on when ``landmarks`` is given).
    ``refresh_landmarks``: rebuild the landmark tables on every
    ``apply_delta`` (default) or let them go stale.

    ``planner``: ``True`` or a :class:`WavePlanner` routes each p2p
    wave's misses through the planner (``stats["planner_routes"]``).
    ``bidirectional``: attach a :class:`BidirectionalSolver` on the
    service's device, sharing the landmark index; without the planner
    every scalar-target miss meets in the middle.  ``reselect``: a
    tightness threshold or :class:`ReselectPolicy` checked after every
    delta and every served wave.
    """

    def __init__(self, graph, cfg: SSSPConfig = SP4_CONFIG,
                 backend: str = "auto", *, batch: int = 8,
                 cache_sources: int = 1024,
                 landmarks: int | LandmarkIndex | None = None,
                 p2p: bool | None = None, refresh_landmarks: bool = True,
                 landmark_seed: int = 0,
                 planner: bool | WavePlanner | None = None,
                 bidirectional: bool = False,
                 reselect: float | ReselectPolicy | None = None,
                 **solver_kw):
        self.solver = DynamicSolver(graph, cfg, backend, **solver_kw)
        self.device = self.solver.device
        self._sync = SyncCounter()     # the service's own device reads
        self.batch = int(batch)
        self.cache_sources = max(1, int(cache_sources))
        # source -> (version at solve time, result, partial); entries
        # whose version trails the solver's are stale == misses; partial
        # entries only answer targets their fixed mask certifies.
        self._cache: OrderedDict[
            int, tuple[int, SSSPResult, bool]] = OrderedDict()
        # (source, target) -> (version, distance, path, lanes):
        # bidirectional answers; `lanes` keeps the answer's [2, n] (D,
        # fixed) device state so a delta can re-solve hot pairs warm.
        self._pairs: OrderedDict[
            tuple[int, int],
            tuple[int, float, list | None, tuple | None]] = OrderedDict()
        self.landmarks: LandmarkIndex | None = None
        if isinstance(landmarks, LandmarkIndex):
            self.landmarks = landmarks
        elif landmarks is not None:
            self.landmarks = LandmarkIndex(
                self.solver.graph, int(landmarks), cfg=self.solver.cfg,
                backend=backend if backend != "auto" else "segment",
                seed=landmark_seed, solver=self.solver,
                group=self.solver.group)
        self.refresh_landmarks = bool(refresh_landmarks)
        self.planner: WavePlanner | None = None
        if isinstance(planner, WavePlanner):
            self.planner = planner
        elif planner:
            self.planner = WavePlanner()
        self._bidi: BidirectionalSolver | None = None
        if bidirectional:
            self._bidi = BidirectionalSolver(
                self.solver.graph, self.solver.cfg,
                landmarks=self.landmarks, device=self.device)
        # the v2 routes live on the p2p pipeline: asking for the planner
        # or the bidirectional solver opts scalar-target queries into it
        # even without landmarks (targeted waves then run unseeded).
        self.p2p = bool(self.landmarks is not None
                        or self.planner is not None
                        or self._bidi is not None
                        if p2p is None else p2p)
        self.reselect_policy: ReselectPolicy | None = None
        if isinstance(reselect, ReselectPolicy):
            self.reselect_policy = reselect
        elif reselect is not None:
            self.reselect_policy = ReselectPolicy(threshold=float(reselect))
        self.stats = dict(queries=0, batches=0, sources_solved=0,
                          cache_hits=0, solve_seconds=0.0, deltas=0,
                          delta_seconds=0.0, warm_refreshed=0,
                          p2p_solves=0, seed_tightness_mean=None,
                          seed_tightness_count=0, bidi_solves=0,
                          reselects=0, pair_warm_refreshed=0,
                          planner_routes=dict(cache=0, targeted=0,
                                              bidirectional=0, full=0,
                                              full_vector=0))

    # ------------------------------------------------------------------
    @property
    def version(self) -> int:
        """Graph version (number of deltas applied)."""
        return self.solver.version

    @property
    def host_reads(self) -> int:
        """Device->host reads the service made itself (the solvers count
        theirs in their results)."""
        return self._sync.count

    def _block(self) -> None:
        """Wait for the device work queued so far, so a timer ends after
        it (torch's sync debug mode is lifted: this wait is deliberate)."""
        if self.device.type != "cuda":
            return
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            torch.cuda.synchronize(self.device)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def _probe(self, queries: list[Query]) -> dict[tuple[int, int], bool]:
        """``fixed[target]`` of every fresh partial entry these queries
        may probe, in one read (the cache does not change while a wave
        probes it)."""
        cells: dict[tuple[int, int], torch.Tensor] = {}
        for q in queries:
            entry = self._cache.get(q.source)
            if entry is not None and entry[0] == self.version and entry[2]:
                cells.setdefault((q.source, q.target),
                                 entry[1].fixed[q.target])
        if not cells:
            return {}
        return dict(zip(cells, self._sync.read(torch.stack(list(
            cells.values())))))

    def _lookup(self, source: int, target: int | None = None,
                fixed: dict | None = None) -> SSSPResult | None:
        """Fresh cached result usable for this request, else None.

        A full entry answers anything; a partial entry answers only a
        scalar ``target`` its ``fixed`` mask certifies exact (read from
        the wave's ``_probe``) and never a full-vector request.
        """
        entry = self._cache.get(source)
        if entry is None:
            return None
        ver, res, partial = entry
        if ver != self.version:        # stale: solved on an older graph
            del self._cache[source]
            return None
        if partial:
            if target is None or not fixed[(source, target)]:
                return None            # keep the entry: other targets may hit
        self._cache.move_to_end(source)
        return res

    def _admit(self, source: int, res: SSSPResult, *,
               partial: bool = False) -> None:
        if partial and self._cached(source):
            return  # never downgrade a fresh full entry to a partial one
        self._cache[source] = (self.version, res, partial)
        self._cache.move_to_end(source)
        while len(self._cache) > self.cache_sources:
            self._cache.popitem(last=False)

    def _cached(self, source: int) -> bool:
        """Fresh FULL entry present (partial entries don't count)."""
        entry = self._cache.get(source)
        return (entry is not None and entry[0] == self.version
                and not entry[2])

    def _pair_lookup(self, source: int,
                     target: int) -> tuple[float, list | None] | None:
        """Fresh bidirectional pair-cache answer, else None."""
        entry = self._pairs.get((source, target))
        if entry is None:
            return None
        if entry[0] != self.version:
            del self._pairs[(source, target)]
            return None
        self._pairs.move_to_end((source, target))
        return entry[1], entry[2]

    def _pair_admit(self, source: int, target: int, distance: float,
                    path: list | None, lanes: tuple | None = None) -> None:
        self._pairs[(source, target)] = (self.version, distance, path, lanes)
        self._pairs.move_to_end((source, target))
        while len(self._pairs) > self.cache_sources:
            self._pairs.popitem(last=False)

    def _solve_missing(self, sources: list[int]) -> None:
        """Batch-solve sources not freshly cached, ``self.batch`` at a time."""
        missing = [s for s in dict.fromkeys(sources)
                   if not self._cached(s)]
        for at in range(0, len(missing), self.batch):
            chunk = missing[at: at + self.batch]
            padded = chunk + [chunk[-1]] * (self.batch - len(chunk))
            t0 = time.perf_counter()
            batch_res = self.solver.solve_batch(padded)
            self._block()
            self.stats["solve_seconds"] += time.perf_counter() - t0
            self.stats["batches"] += 1
            for i, s in enumerate(chunk):
                self._admit(s, batch_res[i])
            self.stats["sources_solved"] += len(chunk)

    def _answer(self, answers: list[tuple[Query, SSSPResult]]) -> None:
        """Fill each query from its result: ``dist`` for a full-vector
        query, else ``distance`` and ``path``.  One read for the vectors,
        one for the scalars, then the parent pointers of the results
        with a reachable target, ``_PARENT_ROWS`` rows a pass and read."""
        vec = [(q, r) for q, r in answers if q.target is None]
        scal = [(q, r) for q, r in answers if q.target is not None]
        if vec:
            rows = self._sync.read_numpy(torch.stack([r.dist for _, r in vec]))
            for i, (q, _) in enumerate(vec):
                q.dist, q.distance, q.path = rows[i], None, None
                q.done = True
        if not scal:
            return
        vals = self._sync.read(torch.stack([r.dist[q.target]
                                            for q, r in scal]))
        for (q, _), d in zip(scal, vals):
            q.distance = float(d)
        self._fill_parents([r for q, r in scal if np.isfinite(q.distance)])
        for q, r in scal:
            q.path = (r.path_to(q.target) if np.isfinite(q.distance)
                      else None)
            q.done = True

    def _fill_parents(self, results: list[SSSPResult]) -> None:
        """Parent pointers of the results that lack them, computed and
        read ``_PARENT_ROWS`` rows at a time per graph version (the same
        int32 values as ``SSSPResult.parents``, one pass for a chunk)."""
        groups: dict[int, list[SSSPResult]] = {}
        seen: set[int] = set()
        for r in results:
            if r._parents is None and id(r) not in seen:
                seen.add(id(r))
                groups.setdefault(id(r.graph), []).append(r)
        for rs in groups.values():
            for at in range(0, len(rs), _PARENT_ROWS):
                chunk = rs[at: at + _PARENT_ROWS]
                rows = self._sync.read_numpy(parent_pointers(
                    chunk[0].graph, torch.stack([r.dist for r in chunk])))
                for r, row in zip(chunk, rows):
                    r._parents = row

    # ------------------------------------------------------------------
    def apply_delta(self, delta: GraphDelta, *,
                    refresh_hot: int | None = None) -> dict:
        """Apply a weight delta; warm-refresh the hottest cached sources.

        The ``refresh_hot`` most-recently-used *fully*-cached sources
        (default: one solve batch's worth; 0 = none; partial entries are
        skipped) are re-solved through the DynamicSolver's warm path and
        re-admitted fresh; the rest of the LRU stays resident but
        version-stamped stale.  The landmark index rides the same update
        (its forward tables are tracked sources of this solver), and the
        hottest fresh bidirectional pairs re-solve warm from their cached
        lanes.  Returns the solver's update stats.
        """
        k = self.batch if refresh_hot is None else int(refresh_hot)
        hot: list[int] = []
        if k > 0:   # newest-first walk for the k hottest FULL entries
            for s in reversed(self._cache):
                if len(hot) == k:
                    break
                if not self._cache[s][2]:
                    hot.append(s)
            hot.reverse()
        # the k hottest still-fresh pairs that carried their lane state
        # (collected before the version bump makes every stamp stale)
        hot_pairs: list[tuple[int, int, object, object]] = []
        if self._bidi is not None and k > 0:
            for key in reversed(self._pairs):
                if len(hot_pairs) == k:
                    break
                ver, _, _, lanes = self._pairs[key]
                if ver == self.version and lanes is not None:
                    hot_pairs.append((key[0], key[1], lanes[0], lanes[1]))
            hot_pairs.reverse()
        t0 = time.perf_counter()
        eager_lm = self.landmarks is not None and self.refresh_landmarks
        lms = ([int(v) for v in self.landmarks.landmarks]
               if eager_lm else [])
        stats = self.solver.update(
            delta, refresh=list(dict.fromkeys(hot + lms)))
        if self.landmarks is not None:
            self.landmarks.apply_delta(delta, refresh=eager_lm)
        if self._bidi is not None:
            # both bidi lanes take the same delta, and the hot pairs
            # re-solve warm from their cached lanes, re-admitted fresh
            warm_out = self._bidi.update(delta, warm=hot_pairs)
            for (s, t), r in warm_out.items():
                self._pair_admit(s, t, r.distance,
                                 r.path() if np.isfinite(r.distance)
                                 else None, lanes=(r.D, r.fixed))
                self._admit(s, r.forward_result(), partial=True)
            self.stats["pair_warm_refreshed"] += len(warm_out)
        if hot:
            refreshed = self.solver.resolve(hot)  # tracked: no new solves
            for i, s in enumerate(hot):
                self._admit(int(s), refreshed[i])
        self._block()
        # delta work gets its own timer: solve_seconds stays consistent
        # with batches/sources_solved (the query-path counters).
        self.stats["delta_seconds"] += time.perf_counter() - t0
        self.stats["deltas"] += 1
        self.stats["warm_refreshed"] += stats["warm_refreshed"]
        self.stats["sources_solved"] += stats["cold_refreshed"]
        self._maybe_reselect()
        return stats

    def _maybe_reselect(self) -> bool:
        """Act on landmark drift under the configured policy (no-op when
        re-selection is off).  Cached results stay valid: partial entries
        certify exactness through their ``fixed`` masks whatever seeds
        produced them, so only the seed/estimate tables change hands."""
        if self.landmarks is None or self.reselect_policy is None:
            return False
        if not self.landmarks.maybe_reselect(self.reselect_policy):
            return False
        self.stats["reselects"] += 1
        # mirror the reset accumulator (fresh signal for new positions)
        self.stats["seed_tightness_mean"] = self.landmarks.tightness()
        self.stats["seed_tightness_count"] = self.landmarks.tightness_count
        return True

    # ------------------------------------------------------------------
    def serve(self, queries: list[Query]) -> list[Query]:
        """Answer a wave of queries in place (distance + path).

        With ``p2p`` on, scalar-target queries take the goal-directed
        path (targeted early-exit solves, landmark-seeded when an index
        is attached); full-vector queries always take the full path.
        """
        n = self.solver.graph.n
        bad = [q for q in queries
               if not (0 <= q.source < n
                       and (q.target is None or 0 <= q.target < n))]
        if bad:
            # checked on the host before any indexing: on the card an
            # out-of-range index is a device-side assert, not an error
            raise ValueError(
                f"{len(bad)} queries reference vertices outside [0, {n}): "
                f"first bad query {bad[0]}")
        if not self.p2p:
            if self.planner is not None:
                return self._serve_full_planned(queries)
            return self._serve_full(queries)
        full_q = [q for q in queries if q.target is None]
        tgt_q = [q for q in queries if q.target is not None]
        if full_q:
            if self.planner is not None:
                self._serve_full_planned(full_q)
            else:
                self._serve_full(full_q)
        if tgt_q:
            if self.planner is not None or self._bidi is not None:
                self._serve_planned(tgt_q)
            else:
                self._serve_p2p(tgt_q)
        self._maybe_reselect()
        return queries

    def _serve_full(self, queries: list[Query]) -> list[Query]:
        """Full solve per (cache-missing) source."""
        # a hit = a query answered without a solve on its behalf: neither
        # the first query of an initially-missing source (it pays for the
        # batch solve) nor an eviction-triggered mid-wave re-solve.
        misses = {q.source for q in queries
                  if not self._cached(q.source)}
        self.stats["queries"] += len(queries)
        self._solve_missing([q.source for q in queries])
        paid = set()   # missing sources whose triggering query is consumed
        answers = []
        for q in queries:
            res = self._lookup(q.source)
            if res is None:  # evicted mid-wave: cache smaller than the wave
                self._solve_missing([q.source])
                res = self._lookup(q.source)
            elif q.source in misses and q.source not in paid:
                paid.add(q.source)
            else:
                self.stats["cache_hits"] += 1
            answers.append((q, res))
        self._answer(answers)
        return queries

    def _serve_full_planned(self, queries: list[Query]) -> list[Query]:
        """Planner-routed full path: miss sources become pow-2-shaped
        waves (``plan_full_vector``), the route's measured cost feeds the
        planner under ``full_vector``, and ``stats["planner_routes"]``
        counts each query (hits as ``cache``).  Answers as
        :meth:`_serve_full`'s."""
        routes = self.stats["planner_routes"]
        misses = {q.source for q in queries
                  if not self._cached(q.source)}
        self.stats["queries"] += len(queries)
        for wave in self.planner.plan_full_vector(
                sorted(misses), batch=self.batch):
            shape = WavePlanner.wave_shape(len(wave), self.batch)
            padded = wave + [wave[-1]] * (shape - len(wave))
            t0 = time.perf_counter()
            batch_res = self.solver.solve_batch(padded)
            self._block()
            dt = time.perf_counter() - t0
            self.stats["solve_seconds"] += dt
            self.stats["batches"] += 1
            for i, s in enumerate(wave):
                self._admit(s, batch_res[i])
            self.stats["sources_solved"] += len(wave)
            self.planner.observe("full_vector", dt, len(wave))
        paid = set()   # missing sources whose triggering query is consumed
        answers = []
        for q in queries:
            res = self._lookup(q.source)
            if res is None:  # evicted mid-wave: cache smaller than the wave
                self._solve_missing([q.source])
                res = self._lookup(q.source)
                routes["full_vector"] += 1
            elif q.source in misses and q.source not in paid:
                paid.add(q.source)
                routes["full_vector"] += 1
            else:
                self.stats["cache_hits"] += 1
                routes["cache"] += 1
            answers.append((q, res))
        self._answer(answers)
        return queries

    def _serve_p2p(self, queries: list[Query]) -> list[Query]:
        """Goal-directed path for scalar-target queries.

        Cache first (full entries answer anything; partial entries
        answer targets their ``fixed`` mask certifies); the remaining
        pairs are batched into targeted early-exit solves, sorted by the
        landmark estimate ``C0[t]`` so short queries ride with short
        batches, and the partial results admitted ``partial=True``.
        Answers come from the wave-local results dict, so mid-wave
        eviction can never orphan a query.
        """
        self.stats["queries"] += len(queries)
        fixed = self._probe(queries)
        hits: dict[int, SSSPResult] = {}
        need: list[tuple[int, int]] = []
        for q in queries:
            res = self._lookup(q.source, target=q.target, fixed=fixed)
            if res is not None:
                hits[id(q)] = res
            else:
                need.append((q.source, q.target))
        need = list(dict.fromkeys(need))
        if self.landmarks is not None and len(need) > 1:
            est = self.landmarks.estimate_pairs(need)
            if est is not None:
                order = np.argsort(est, kind="stable")
                need = [need[i] for i in order]
        solved: dict[tuple[int, int], SSSPResult] = {}
        for at in range(0, len(need), self.batch):
            chunk = need[at: at + self.batch]
            solved.update(self._targeted_wave(chunk, self.batch))
        paid: set[tuple[int, int]] = set()
        answers = []
        for q in queries:
            res = hits.get(id(q))
            if res is not None:
                self.stats["cache_hits"] += 1
            else:
                res = solved[(q.source, q.target)]
                # duplicate pairs in one wave: only the first query pays
                # for the solve, the rest are hits
                if (q.source, q.target) in paid:
                    self.stats["cache_hits"] += 1
                else:
                    paid.add((q.source, q.target))
            answers.append((q, res))
        self._answer(answers)
        return queries

    def _targeted_wave(self, chunk: list[tuple[int, int]],
                       shape: int) -> dict[tuple[int, int], SSSPResult]:
        """One targeted early-exit solve over ``chunk``, padded to
        ``shape`` slots; admits partials and feeds the tightness +
        planner cost telemetry.  Returns per-pair results."""
        padded = chunk + [chunk[-1]] * (shape - len(chunk))
        srcs = [s for s, _ in padded]
        tgts = [t for _, t in padded]
        t0 = time.perf_counter()
        C0 = (self.landmarks.seed_batch(srcs)
              if self.landmarks is not None else None)
        batch_res = self.solver.solve_batch(srcs, targets=tgts, C0=C0)
        self._block()
        dt = time.perf_counter() - t0
        self.stats["solve_seconds"] += dt
        self.stats["batches"] += 1
        self.stats["p2p_solves"] += len(chunk)
        if self.planner is not None:
            self.planner.observe("targeted", dt, len(chunk))
        solved: dict[tuple[int, int], SSSPResult] = {}
        for i, (s, t) in enumerate(chunk):
            res = batch_res[i]
            solved[(s, t)] = res
            self._admit(s, res, partial=batch_res.partial)
        if C0 is not None:
            self._record_tightness(C0, batch_res, chunk)
        return solved

    def _serve_bidi(
            self, pairs: list[tuple[int, int]], est=None,
    ) -> dict[tuple[int, int], tuple[float, list | None]]:
        """Meet-in-the-middle solves for ``pairs``; answers go to the
        pair cache, each forward lane to the source cache as a partial
        entry, and estimate/distance ratios into the tightness signal."""
        out: dict[tuple[int, int], tuple[float, list | None]] = {}
        if not pairs:
            return out
        t0 = time.perf_counter()
        ratios = []
        for i, (s, t) in enumerate(pairs):
            r = self._bidi.solve(s, t)
            ans = (r.distance,
                   r.path() if np.isfinite(r.distance) else None)
            out[(s, t)] = ans
            self._pair_admit(s, t, ans[0], ans[1], lanes=(r.D, r.fixed))
            self._admit(s, r.forward_result(), partial=True)
            if est is not None:
                e = float(est[i])
                if np.isfinite(e) and np.isfinite(ans[0]) and ans[0] > 0:
                    ratios.append(e / ans[0])
        dt = time.perf_counter() - t0
        self.stats["solve_seconds"] += dt
        self.stats["bidi_solves"] += len(pairs)
        if self.planner is not None:
            self.planner.observe("bidirectional", dt, len(pairs))
        if ratios and self.landmarks is not None:
            self.landmarks.record_tightness(np.asarray(ratios))
            self.stats["seed_tightness_mean"] = self.landmarks.tightness()
            self.stats["seed_tightness_count"] = \
                self.landmarks.tightness_count
        return out

    def _serve_planned(self, queries: list[Query]) -> list[Query]:
        """Query-engine v2: plan each wave across the four routes.

        Cache (source entries AND the bidirectional pair cache) is
        probed first; the misses go through :meth:`WavePlanner.plan`, or
        all-bidirectional when ``bidirectional=True`` without a planner,
        and each route's answers are joined wave-locally.
        """
        self.stats["queries"] += len(queries)
        routes = self.stats["planner_routes"]
        fixed = self._probe(queries)
        hits: dict[int, SSSPResult | tuple[float, list | None]] = {}
        need: list[tuple[int, int]] = []
        for q in queries:
            ans = self._pair_lookup(q.source, q.target)
            if ans is None:
                ans = self._lookup(q.source, target=q.target, fixed=fixed)
            if ans is not None:
                hits[id(q)] = ans
            else:
                need.append((q.source, q.target))
        need = list(dict.fromkeys(need))
        est = (self.landmarks.estimate_pairs(need)
               if self.landmarks is not None and need else None)
        if self.planner is not None:
            plan = self.planner.plan(need, est, batch=self.batch,
                                     bidi_ok=self._bidi is not None)
        else:   # bidirectional-only mode: every miss meets in the middle
            plan = WavePlan(full_sources=[], full_pairs=[],
                            bidi_pairs=list(need), targeted_waves=[])
        if plan.full_sources:
            t0 = time.perf_counter()
            self._solve_missing(plan.full_sources)
            if self.planner is not None:
                self.planner.observe(
                    "full", time.perf_counter() - t0, len(plan.full_pairs))
        if plan.bidi_pairs:
            bidi_est = (None if est is None else
                        [est[need.index(p)] for p in plan.bidi_pairs])
            bidi_out = self._serve_bidi(plan.bidi_pairs, bidi_est)
        else:
            bidi_out = {}
        solved: dict[tuple[int, int], SSSPResult] = {}
        for wave in plan.targeted_waves:
            shape = WavePlanner.wave_shape(len(wave), self.batch)
            solved.update(self._targeted_wave(wave, shape))
        full_keys = set(plan.full_pairs)
        paid: set[tuple[int, int]] = set()
        answers = []
        for q in queries:
            key = (q.source, q.target)
            ans = hits.get(id(q))
            if ans is not None:
                routes["cache"] += 1
                self.stats["cache_hits"] += 1
                if isinstance(ans, tuple):
                    q.distance, q.path = ans
                    q.done = True
                else:
                    answers.append((q, ans))
                continue
            if key in bidi_out:
                routes["bidirectional"] += 1
                q.distance, q.path = bidi_out[key]
                q.done = True
            elif key in full_keys:
                routes["full"] += 1
                res = self._lookup(q.source)
                if res is None:   # evicted mid-wave: re-solve on demand
                    self._solve_missing([q.source])
                    res = self._lookup(q.source)
                answers.append((q, res))
            else:
                routes["targeted"] += 1
                answers.append((q, solved[key]))
            # duplicate pairs in one wave: only the first query pays
            if key in paid:
                self.stats["cache_hits"] += 1
            else:
                paid.add(key)
        self._answer(answers)
        return queries

    def _record_tightness(self, C0, batch_res, chunk) -> None:
        """Seed-tightness telemetry: mean ``C0[target] / dist[target]``
        over served seeded queries (1.0 = seed already exact, -> 0 =
        landmarks drifting off the mutated metric), kept in ``stats``
        and mirrored into the :class:`LandmarkIndex`.  The 2 x len(chunk)
        f32 values are gathered on the device and read once; the ratios
        are taken in float64 on the host, as the reference takes them."""
        cells = []
        for i, (_, t) in enumerate(chunk):
            cells += [C0[i, t], batch_res.dist[i, t]]
        vals = np.asarray(self._sync.read(torch.stack(cells)),
                          np.float64).reshape(-1, 2)
        seed, dist = vals[:, 0], vals[:, 1]
        ok = np.isfinite(dist) & (dist > 0) & np.isfinite(seed)
        if not ok.any():
            return
        self.landmarks.record_tightness(seed[ok] / dist[ok])
        # single source of truth: the index's accumulator (so a
        # reset_tightness() is reflected here too, never a stale fork)
        self.stats["seed_tightness_mean"] = self.landmarks.tightness()
        self.stats["seed_tightness_count"] = self.landmarks.tightness_count

    def distances(self, source: int) -> np.ndarray:
        """Full distance vector for one source (through the cache)."""
        self._solve_missing([source])
        return self._sync.read_numpy(self._lookup(source).dist)
