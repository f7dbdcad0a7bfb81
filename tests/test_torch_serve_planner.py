"""Port parity for the wave planner (``repro_torch.runtime.planner``):
the reference's ``WavePlanner`` and the port's fed the same ``plan`` /
``plan_full_vector`` / ``observe`` sequences give identical
``WavePlan``s, EMA costs, eligibility and popularity windows, estimates
with ``nan`` and ``inf`` included.  Mirrors the planner tests of
``test_serve_v2.py`` and ``test_fleet.py``, each run on both planners
side by side, plus seeded random sequences and the planner's own
``_next_pow2`` (``wave_shape(0, b) == 1``, unlike the solver's)."""
import math

import numpy as np
import pytest

from repro.runtime import planner as RP
from repro_torch.runtime import planner as PP


def _plan(p):
    """A WavePlan as plain values."""
    return (p.full_sources, p.full_pairs, p.bidi_pairs, p.targeted_waves,
            p.route_counts())


def both(fn):
    """``fn(planner module)`` on the reference's module and the port's;
    the two records must be equal.  Returns the port's."""
    r, p = fn(RP), fn(PP)
    assert r == p
    return p


def _state(pl):
    return ({k: pl.cost(k) for k in PP.ROUTES}, pl._bidi_eligible(),
            dict(pl._pop), pl.waves_planned)


def test_planner_full_promotion_single_wave():
    def run(m):
        pl = m.WavePlanner(full_share=0.5)
        pairs = [(7, t) for t in range(4)] + [(1, 9), (2, 9)]
        return _plan(pl.plan(pairs, batch=8)), _state(pl)
    (full, full_pairs, _, waves, _), _ = both(run)
    assert full == [7] and len(full_pairs) == 4
    assert sum(len(w) for w in waves) == 2


def test_planner_full_promotion_across_waves():
    def run(m):
        pl = m.WavePlanner(full_share=0.5, pop_decay=0.8)
        out = []
        for wave in range(6):
            plan = pl.plan([(3, 10 + wave), (3, 40 + wave),
                            (5, 60 + wave)], batch=8)
            out.append((_plan(plan), _state(pl)))
            if 3 in plan.full_sources:
                break
        out.append((_plan(pl.plan([(3, 99)], batch=8)), _state(pl)))
        return out
    out = both(run)
    assert 3 in out[-2][0][0] and 5 not in out[-2][0][0]
    assert 3 not in out[-1][0][0]           # promotion restarts the window


def test_planner_bidi_far_tail_and_cap():
    def run(m):
        pl = m.WavePlanner(bidi_frac=0.75)
        pairs = [(i, 50 + i) for i in range(10)]
        est = np.array([1.0] * 8 + [100.0, 90.0])
        return (_plan(pl.plan(pairs, est, batch=2, bidi_ok=True)),
                _plan(pl.plan(pairs, est, batch=2)), _state(pl))
    with_bidi, without, _ = both(run)
    assert sorted(with_bidi[2]) == [(8, 58), (9, 59)]
    assert sum(len(w) for w in with_bidi[3]) == 8
    assert without[2] == [] and sum(len(w) for w in without[3]) == 10


def test_planner_bidi_cost_gate():
    def run(m):
        pl = m.WavePlanner(margin=1.5)
        out = [pl._bidi_eligible()]
        pl.observe("targeted", 1.0, 10)
        pl.observe("bidirectional", 1.0, 1)
        out.append(_state(pl))
        out.append(_plan(pl.plan([(0, 1), (0, 2)], np.array([1.0, 100.0]),
                                 batch=8, bidi_ok=True)))
        for _ in range(12):
            pl.observe("bidirectional", 0.1, 1)
        out.append(_state(pl))
        return out
    out = both(run)
    assert out[0] and not out[1][1] and out[2][2] == [] and out[3][1]


def test_planner_observe_ema_and_validation():
    def run(m):
        pl = m.WavePlanner(ema=0.5)
        costs = [pl.cost("targeted")]
        for sec, cnt in ((2.0, 2), (1.0, 2), (1.0, 0), (3.0, -1)):
            pl.observe("targeted", sec, cnt)
            costs.append(pl.cost("targeted"))
        with pytest.raises(ValueError, match="unknown route"):
            pl.observe("warp", 1.0, 1)
        return costs
    assert both(run) == [None, 1.0, 0.75, 0.75, 0.75]


def test_planner_targeted_waves_sorted_and_shaped():
    def run(m):
        pl = m.WavePlanner()
        pairs = [(i, i + 50) for i in range(5)]
        est = np.array([9.0, 1.0, 5.0, 3.0, 7.0])
        shapes = [m.WavePlanner.wave_shape(k, b)
                  for k in range(0, 12) for b in (0, 1, 3, 4, 8)]
        return _plan(pl.plan(pairs, est, batch=4)), shapes
    (_, _, _, waves, _), shapes = both(run)
    assert [p for w in waves for p in w] == [(1, 51), (3, 53), (2, 52),
                                             (4, 54), (0, 50)]
    assert [len(w) for w in waves] == [4, 1]
    ws = PP.WavePlanner.wave_shape
    assert (ws(0, 8), ws(1, 8), ws(3, 8), ws(5, 8), ws(9, 8)) == (
        1, 1, 4, 8, 8)
    assert PP._next_pow2(0) == 1 and PP._next_pow2(1) == 1


def test_wave_plan_route_counts():
    def run(m):
        return m.WavePlan(full_sources=[1], full_pairs=[(1, 2), (1, 3)],
                          bidi_pairs=[(4, 5)],
                          targeted_waves=[[(6, 7)], [(8, 9), (10, 11)]]
                          ).route_counts()
    assert both(run) == {"full": 2, "bidirectional": 1, "targeted": 3}


def test_planner_full_vector_waves_and_cost():
    def run(m):
        pl = m.WavePlanner()
        waves = [pl.plan_full_vector([9, 3, 9, 5], batch=8),
                 pl.plan_full_vector(list(range(11)), batch=4),
                 pl.plan_full_vector([], batch=0)]
        pl.observe("full_vector", 0.5, 10)
        return waves, _state(pl)
    waves, state = both(run)
    assert waves[0] == [[9, 3, 5]] and [len(w) for w in waves[1]] == [4, 4, 3]
    assert state[0]["full_vector"] == pytest.approx(0.05)


def test_planner_nonfinite_estimates():
    """nan (no information) and inf (unreachable) estimates: never bidi,
    sorted last as the reference sorts them, with or without a finite
    maximum in the wave."""
    def run(m):
        pl = m.WavePlanner(bidi_frac=0.5)
        out = []
        for est in ([np.nan, 2.0, np.inf, 8.0, 7.0, np.nan, 0.5, np.inf],
                    [np.nan] * 8, [np.inf] * 8, [0.0] * 8,
                    [np.inf, np.nan, 0.0, 3.0, 3.0, np.nan, 1.0, 3.0]):
            pairs = [(20 + i, 40 + i) for i in range(len(est))]
            out.append(_plan(pl.plan(pairs, np.asarray(est), batch=4,
                                     bidi_ok=True)))
        out.append(_plan(pl.plan([(1, 2), (3, 4)], None, batch=4,
                                 bidi_ok=True)))
        return out, _state(pl)
    out, _ = both(run)
    assert out[0][2] == [(23, 43), (24, 44)]   # finite and >= 0.5 * 8
    assert out[1][2] == out[2][2] == out[3][2] == out[5][2] == []


@pytest.mark.parametrize("seed", range(6))
def test_planner_random_sequences(seed):
    """Seeded random waves (repeated sources, estimates with nan/inf,
    varying batch and bidi_ok, interleaved observations) through both
    planners: every plan and every state equal."""
    def run(m):
        rng = np.random.default_rng(seed)
        pl = m.WavePlanner(full_share=float(rng.uniform(0.2, 0.8)),
                           bidi_frac=float(rng.uniform(0.3, 0.9)),
                           margin=float(rng.uniform(0.5, 2.0)),
                           ema=float(rng.uniform(0.1, 0.9)),
                           pop_decay=float(rng.uniform(0.0, 0.95)))
        out = []
        for _ in range(12):
            k = int(rng.integers(1, 20))
            pairs = list(dict.fromkeys(
                (int(s), int(t)) for s, t in zip(rng.integers(0, 6, k),
                                                 rng.integers(0, 50, k))))
            est = rng.uniform(0, 10, len(pairs))
            est[rng.random(len(pairs)) < 0.2] = np.nan
            est[rng.random(len(pairs)) < 0.2] = np.inf
            batch = int(rng.integers(1, 9))
            plan = pl.plan(pairs, est if rng.random() < 0.8 else None,
                           batch=batch, bidi_ok=bool(rng.random() < 0.7))
            out.append(_plan(plan))
            for route in ("targeted", "bidirectional", "full",
                          "full_vector"):
                if rng.random() < 0.5:
                    pl.observe(route, float(rng.uniform(0, 1)),
                               int(rng.integers(0, 4)))
            out.append(pl.plan_full_vector(
                [int(s) for s in rng.integers(0, 9, 5)], batch=batch))
            out.append(_state(pl))
        return out
    out = both(run)
    assert all(not isinstance(c, float) or math.isfinite(c)
               for state in out[2::3] for c in state[0].values())
