"""Congestion replay over a graph fleet, with chaos hooks (port of
``repro/runtime/fleet.py``).

F same-shape road networks, each with its own rush hour.  Every tick
each member gets a regional weight drift (a window of source vertices,
weights rescaled up and down), the F deltas stack into one
``FleetSolver.update`` that warm-refreshes the tracked home solves, and
query traffic is served from per-member version-stamped source caches,
the tick's misses over all members in one ``[F, B]`` ``solve_batch``.

Chaos from ``distributed.fault.FaultInjector``:

  * ``("dropout", member)``: the device state is lost.  The driver
    restores the last checkpoint (the weights, the tracked solves and
    the tick: on disk through a ``CheckpointManager``, else a snapshot
    cloned on the device), clears the caches (their stamps would alias
    the rolled-back version) and replays the dropped ticks.  Tick work
    is a function of ``(seed, tick, member)`` alone, so the run ends
    bitwise equal to a fault-free one.
  * ``("straggler", delay_ms)``: one virtual host stalls a tick; its
    ``StepTimer`` records the stall and ``detect_stragglers`` flags it.
"""
from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.sssp.dynamic import make_delta
from repro_torch.core.sssp.fleet import FleetSolver, GraphFleet, stack_deltas
from repro_torch.distributed.fault import (FaultInjector, StepTimer,
                                           detect_stragglers)


def regional_drift(src: np.ndarray, w_row: np.ndarray, n: int, *,
                   seed: int, tick: int, member: int, region: int,
                   drift_edges: int) -> tuple[np.ndarray, np.ndarray]:
    """One member's tick-``tick`` drift: ``(edge_idx, new_w)``,
    deterministic in ``(seed, tick, member)``."""
    rng = np.random.default_rng((seed, tick, member))
    lo = int(rng.integers(0, n))
    idx = np.nonzero((src >= lo) & (src < lo + region))[0]
    if len(idx) > drift_edges:
        idx = rng.choice(idx, drift_edges, replace=False)
    if len(idx) == 0:                          # window missed all edges
        idx = rng.integers(0, len(src), size=1)
    idx = np.sort(idx).astype(np.int64)
    scale = rng.uniform(0.5, 2.5, size=len(idx)).astype(np.float32)
    return idx, np.clip(w_row[idx] * scale, 1e-3, 1e6)


def query_stream(n: int, hot: np.ndarray, *, seed: int, tick: int,
                 member: int, count: int,
                 hot_frac: float) -> list[tuple[int, int]]:
    """One member's tick-``tick`` ``(s, t)`` queries: sources revisit a
    small hot set with probability ``hot_frac``.  Deterministic."""
    rng = np.random.default_rng((seed, tick, member, 7))
    out = []
    for _ in range(count):
        s = (int(rng.choice(hot)) if rng.random() < hot_frac
             else int(rng.integers(0, n)))
        out.append((s, int(rng.integers(0, n))))
    return out


class CongestionReplay:
    """Tick-driven drift, query traffic and chaos over one fleet.

    solver: a ``FleetSolver`` (or a ``GraphFleet`` / list of Graphs).
    seed: base of the per-tick RNG streams ``(seed, tick, member)``.
    drift_edges: most edges drifted a member a tick.
    region_frac: width of the drifting source window, a fraction of n.
    queries_per_tick: (s, t) queries a member a tick.
    hot_frac: probability that a query's source is from the hot set.
    cache_size: LRU capacity of each member's source cache.
    fault: a ``FaultInjector`` or a ``{tick: (kind, arg)}`` schedule.
    manager: a ``checkpoint.CheckpointManager``: checkpoints go to disk
        as step ``tick + 1`` (None: an in-memory snapshot).
    ckpt_every: checkpoint cadence in ticks.
    straggler_z: z-score threshold of ``detect_stragglers``.
    """

    def __init__(self, solver, *, seed: int = 0, drift_edges: int = 16,
                 region_frac: float = 0.125, queries_per_tick: int = 8,
                 hot_frac: float = 0.5, cache_size: int = 32,
                 fault=None, manager=None, ckpt_every: int = 4,
                 straggler_z: float = 3.0):
        if not isinstance(solver, FleetSolver):
            solver = FleetSolver(solver if isinstance(solver, GraphFleet)
                                 else GraphFleet.stack(solver))
        self.solver = solver
        self.fleet = solver.fleet
        self.seed = int(seed)
        self.drift_edges = int(drift_edges)
        self.region = max(1, int(region_frac * self.fleet.n))
        self.queries_per_tick = int(queries_per_tick)
        self.hot_frac = float(hot_frac)
        self.cache_size = int(cache_size)
        if fault is not None and not isinstance(fault, FaultInjector):
            fault = FaultInjector(fault)
        self.fault = fault
        self.manager = manager
        self.ckpt_every = max(1, int(ckpt_every))
        self.straggler_z = float(straggler_z)

        F = self.fleet.size
        # topologies are fixed across the replay: members built once (so
        # make_delta's CSR-permutation cache stays hot) and a host mirror
        # of the weights, so the drift never reads the device
        self.members = self.fleet.members()
        self._src = [m.src[: m.e].cpu().numpy() for m in self.members]
        self._w = self.fleet.g.w.cpu().numpy().copy()       # [F, e_pad]
        self._hot = [np.arange(m * 3 % self.fleet.n,
                               m * 3 % self.fleet.n + 8) % self.fleet.n
                     for m in range(F)]
        self._caches: list[OrderedDict] = [OrderedDict() for _ in range(F)]
        self._timers = {f"host{m}": StepTimer() for m in range(F)}
        self._snap = None
        self.tick = 0
        self.stats = dict(ticks=0, solves=0, warm_refreshes=0, queries=0,
                          cache_hits=0, fleet_dispatches=0, drift_edges=0,
                          restarts=0, chaos_events=0, stragglers_flagged=0,
                          straggler_sleep_s=0.0, drift_s=0.0, query_s=0.0)

        homes = np.arange(F, dtype=np.int32) % self.fleet.n
        self.solver.solve(homes)     # the tracked state the drift refreshes
        self.stats["solves"] += F
        self._checkpoint()           # tick 0 baseline

    # -- checkpoint / restore -------------------------------------------
    def _state(self) -> dict:
        state = dict(self.solver.state_dict())
        state["tick"] = np.int32(self.tick)
        return state

    def _checkpoint(self) -> None:
        state = self._state()
        if self.manager is not None:
            self.manager.save(self.tick + 1, state, blocking=True)
        else:
            self._snap = {k: v.clone() if torch.is_tensor(v) else v
                          for k, v in state.items()}

    def _restore(self) -> None:
        if self.manager is not None:
            _, state = self.manager.restore_latest(self._state())
        else:
            state = {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in self._snap.items()}
        if state is None:
            raise RuntimeError("no checkpoint to restore")
        self.solver.load_state_dict(state)
        self.fleet = self.solver.fleet
        self._w = self.fleet.g.w.cpu().numpy().copy()
        self.tick = int(state["tick"])
        # the version rolled back: stamped entries would alias fresh ones
        for c in self._caches:
            c.clear()
        self.stats["restarts"] += 1

    # -- one tick ----------------------------------------------------------
    def _drift_deltas(self, tick: int):
        """Per-member regional drift, re-derived from (seed, tick, m)."""
        deltas, touched = [], 0
        for m in range(self.fleet.size):
            idx, new_w = regional_drift(
                self._src[m], self._w[m], self.fleet.n, seed=self.seed,
                tick=tick, member=m, region=self.region,
                drift_edges=self.drift_edges)
            self._w[m, idx] = new_w
            touched += len(idx)
            deltas.append(make_delta(self.members[m], idx, new_w))
        return stack_deltas(deltas), touched

    def _serve_queries(self, tick: int) -> None:
        F, n = self.fleet.size, self.fleet.n
        pairs, misses = [], [[] for _ in range(F)]
        for m in range(F):
            for s, t in query_stream(n, self._hot[m], seed=self.seed,
                                     tick=tick, member=m,
                                     count=self.queries_per_tick,
                                     hot_frac=self.hot_frac):
                pairs.append((m, s, t))
        self.stats["queries"] += len(pairs)
        version = self.solver.version
        for m, s, _t in pairs:
            hit = self._caches[m].get(s)
            if hit is not None and hit[0] == version:
                self._caches[m].move_to_end(s)
            elif s not in misses[m]:
                misses[m].append(s)
        # beyond the unique misses every query is a cache hit
        self.stats["cache_hits"] += len(pairs) - sum(map(len, misses))
        width = max(len(ms) for ms in misses)
        if width == 0:
            return
        batch = np.zeros((F, width), np.int32)
        for m, ms in enumerate(misses):
            row = ms + [ms[-1] if ms else 0] * (width - len(ms))
            batch[m] = row if ms else 0
        res = self.solver.solve_batch(batch)
        self.stats["solves"] += F * width
        self.stats["fleet_dispatches"] += 1
        dist = res.dist.cpu().numpy()
        for m, ms in enumerate(misses):
            for i, s in enumerate(ms):
                self._caches[m][s] = (version, dist[m, i])
                self._caches[m].move_to_end(s)
                while len(self._caches[m]) > self.cache_size:
                    self._caches[m].popitem(last=False)

    def step(self) -> None:
        """One tick: drift every member, warm-refresh, serve queries."""
        tick = self.tick
        t0 = time.perf_counter()
        stacked, touched = self._drift_deltas(tick)
        up = self.solver.update(stacked)
        self.fleet = self.solver.fleet
        self.stats["drift_edges"] += touched
        self.stats["warm_refreshes"] += up["warm_refreshed"]
        self.stats["fleet_dispatches"] += 1
        t1 = time.perf_counter()
        self.stats["drift_s"] += t1 - t0
        self._serve_queries(tick)
        self.stats["query_s"] += time.perf_counter() - t1
        self.tick = tick + 1
        self.stats["ticks"] += 1
        if self.tick % self.ckpt_every == 0:
            self._checkpoint()

    # -- driver ------------------------------------------------------------
    def run(self, ticks: int) -> dict:
        """Replay up to tick ``ticks``, weaving in the fault schedule."""
        flagged: set[str] = set()
        while self.tick < ticks:
            ev = self.fault.poll(self.tick) if self.fault else None
            if ev is not None:
                self.stats["chaos_events"] += 1
                if ev[0] == "dropout":
                    # roll back and replay the dropped ticks (poll fires
                    # once, so the replayed tick runs clean)
                    self._restore()
                    continue
                delay = ev[1] / 1000.0
                time.sleep(delay)
                self.stats["straggler_sleep_s"] += delay
                slow = f"host{self.tick % self.fleet.size}"
            else:
                delay, slow = 0.0, None
            t0 = time.perf_counter()
            self.step()
            dt = time.perf_counter() - t0
            for name, timer in self._timers.items():
                # the stall stretches only the slow host's step
                timer.times.append(dt + (delay if name == slow else 0.0))
                timer.times = timer.times[-timer.window:]
            flagged |= set(detect_stragglers(
                {h: t.times for h, t in self._timers.items()},
                z_threshold=self.straggler_z, min_steps=3))
        self.stats["stragglers_flagged"] = len(flagged)
        return dict(self.stats)

    # -- inspection --------------------------------------------------------
    def distances(self) -> np.ndarray:
        """Tracked home-source distances ``[F, n]`` (bitwise stable across
        a dropout and restore)."""
        return self.solver.resolve().dist.cpu().numpy()

    def weights(self) -> np.ndarray:
        return self.fleet.g.w.cpu().numpy()

