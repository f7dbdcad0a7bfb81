"""Cost-based wave planner of the SSSP service (port of
``repro/runtime/planner.py``, numpy only, the same decisions).

The service has four ways to answer a point-to-point query: a cache
lookup, a targeted early-exit wave, a bidirectional meet-in-the-middle
solve, or a full batched solve.  Per wave the planner takes the
deduplicated ``(source, target)`` pairs, the landmark ``C0[t]``
estimates, and an EMA cost model fed by observed per-query seconds, and
emits a :class:`WavePlan`:

======================  =================================================
route                    when
======================  =================================================
``cache``               a fresh entry answers it (probed by the service
                        before planning; never reaches ``plan``).
``full``                a source's decayed cross-wave popularity (plus
                        this wave's slots) reaches ``full_share *
                        batch``: one full solve answers all its targets
                        and seeds the source cache.
``bidirectional``       the landmark estimate puts the target in the
                        farthest ``bidi_frac`` tail of the wave AND the
                        measured bidi per-query cost does not trail the
                        targeted cost by more than ``margin``.
``targeted``            everything else: est-sorted chunks (short
                        queries ride with short batches) padded to the
                        next power of two <= ``batch``.
======================  =================================================

Full-vector queries (``Query(target=None)``) have their own
``full_vector`` route: :meth:`WavePlanner.plan_full_vector` shapes the
miss sources into power-of-two chunks and the route keeps its own EMA
cost and ``stats["planner_routes"]`` accounting.

Cost model: ``observe(route, seconds, count)`` folds measured wall time
into an exponential moving average of per-query seconds per route.
Unmeasured routes are optimistically explored (cost 0), so the model
bootstraps itself; ``cost(route)`` exposes the current estimate.  The
bidirectional route's eligibility therefore depends on the clock: pass
``margin=1e30`` to keep it eligible whatever the timings say.

``_next_pow2`` here returns 1 for x <= 1 (the solver's returns 2 for
x = 0), so ``wave_shape(0, b)`` is 1, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

ROUTES = ("cache", "targeted", "bidirectional", "full", "full_vector")


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


@dataclasses.dataclass
class WavePlan:
    """One wave's routing decision (pairs are deduplicated upstream)."""

    full_sources: list[int]
    full_pairs: list[tuple[int, int]]
    bidi_pairs: list[tuple[int, int]]
    targeted_waves: list[list[tuple[int, int]]]

    def route_counts(self) -> dict[str, int]:
        return {
            "full": len(self.full_pairs),
            "bidirectional": len(self.bidi_pairs),
            "targeted": sum(len(w) for w in self.targeted_waves),
        }


class WavePlanner:
    """Routes wave pairs by structure + measured per-route cost.

    Parameters
    ----------
    full_share: a source hogging this fraction of a batch's slots (at
        least 2 queries, counting ``pop_decay``-decayed history) is
        promoted to one full solve.
    pop_decay:  per-wave decay of the source-popularity accumulator —
        the window over which "hot" is judged (0 = this wave only).
    bidi_frac:  targets whose ``C0[t]`` estimate reaches this fraction
        of the wave's max finite estimate are bidi candidates.
    margin:     bidi stays eligible while its EMA per-query cost is
        below ``margin * targeted_cost`` (>1 keeps exploring a slightly
        slower route; the EMA self-corrects).
    ema:        smoothing factor for the per-route cost averages.
    """

    def __init__(self, *, full_share: float = 0.5, bidi_frac: float = 0.75,
                 margin: float = 1.5, ema: float = 0.3,
                 pop_decay: float = 0.8):
        self.full_share = float(full_share)
        self.bidi_frac = float(bidi_frac)
        self.margin = float(margin)
        self.ema = float(ema)
        self.pop_decay = float(pop_decay)
        self._cost: dict[str, float | None] = {r: None for r in ROUTES}
        self._pop: dict[int, float] = {}
        self.waves_planned = 0

    # ------------------------------------------------------------------
    def observe(self, route: str, seconds: float, count: int) -> None:
        """Fold ``count`` queries served in ``seconds`` into the model."""
        if route not in self._cost:
            raise ValueError(f"unknown route {route!r}")
        if count <= 0:
            return
        per = float(seconds) / count
        old = self._cost[route]
        self._cost[route] = (per if old is None
                             else (1 - self.ema) * old + self.ema * per)

    def cost(self, route: str) -> float | None:
        """EMA per-query seconds for ``route`` (None = never observed)."""
        return self._cost[route]

    def _bidi_eligible(self) -> bool:
        b, t = self._cost["bidirectional"], self._cost["targeted"]
        if b is None or t is None:
            return True          # optimistic exploration bootstraps the EMA
        return b <= self.margin * t

    # ------------------------------------------------------------------
    def plan(self, pairs: list[tuple[int, int]], est=None, *,
             batch: int, bidi_ok: bool = False) -> WavePlan:
        """Split deduplicated ``pairs`` into per-route work lists.

        ``est`` (optional, aligned with ``pairs``) carries the landmark
        lower-bound estimates ``C0[target]``; without it every pair is
        equally near and the bidi route stays cold.
        """
        self.waves_planned += 1
        batch = max(1, int(batch))
        est = (np.full(len(pairs), np.nan)
               if est is None else np.asarray(est, np.float64))

        # --- full route: sources hogging a batch's worth of slots,
        # judged over a decayed cross-wave window (a Zipf-hot source
        # queried a few times EVERY wave must promote, not only one
        # that bursts within a single wave)
        self._pop = {s: p * self.pop_decay
                     for s, p in self._pop.items() if p > 0.05}
        per_src: dict[int, float] = {}
        for s, _ in pairs:
            per_src[s] = per_src.get(s, 0.0) + 1.0
        for s, c in per_src.items():
            self._pop[s] = self._pop.get(s, 0.0) + c
        full_at = max(2.0, self.full_share * batch)
        full_sources = [s for s in per_src if self._pop[s] >= full_at]
        for s in full_sources:      # promoted: restart the window
            del self._pop[s]
        fset = set(full_sources)
        full_pairs = [p for p in pairs if p[0] in fset]
        rest = [(p, est[i]) for i, p in enumerate(pairs) if p[0] not in fset]

        # --- bidirectional route: the far tail, while its cost holds up
        bidi_pairs: list[tuple[int, int]] = []
        if bidi_ok and rest and self._bidi_eligible():
            vals = np.asarray([e for _, e in rest])
            finite = vals[np.isfinite(vals)]
            if finite.size and finite.max() > 0:
                cut = self.bidi_frac * finite.max()
                keep = []
                for p, e in rest:
                    # cap solo solves at one batch's worth per wave
                    if (np.isfinite(e) and e >= cut
                            and len(bidi_pairs) < batch):
                        bidi_pairs.append(p)
                    else:
                        keep.append((p, e))
                rest = keep

        # --- targeted route: est-sorted, power-of-two wave shapes
        order = np.argsort([e if np.isfinite(e) else np.inf
                            for _, e in rest], kind="stable")
        queue = [rest[i][0] for i in order]
        targeted_waves: list[list[tuple[int, int]]] = []
        at = 0
        while at < len(queue):
            take = min(batch, len(queue) - at)
            targeted_waves.append(queue[at: at + take])
            at += take
        return WavePlan(full_sources=full_sources, full_pairs=full_pairs,
                        bidi_pairs=bidi_pairs,
                        targeted_waves=targeted_waves)

    def plan_full_vector(self, sources: list[int], *,
                         batch: int) -> list[list[int]]:
        """Chunk full-vector miss sources into pow-2-shaped waves.

        Distinct sources only (the service probes its cache first);
        chunks are at most ``batch`` wide and each pads to
        :meth:`wave_shape`, so a 3-source miss set costs a 4-lane
        program, not a full batch.
        """
        self.waves_planned += 1
        batch = max(1, int(batch))
        queue = list(dict.fromkeys(int(s) for s in sources))
        return [queue[at: at + batch] for at in range(0, len(queue), batch)]

    @staticmethod
    def wave_shape(wave_len: int, batch: int) -> int:
        """Padded slot count for a targeted wave: next pow2 <= batch."""
        return min(max(1, int(batch)), _next_pow2(wave_len))
