"""Port parity for congestion replay and its fault hooks
(``repro_torch.runtime.fleet``, ``repro_torch.distributed.fault``): a
dropout restart ends bitwise equal to a fault-free port replay and to the
reference's replay at the same seed (weights, tracked distances, stats);
stragglers get flagged; and the port's copy of ``fault.py`` answers as
the reference's on the same inputs.  The on-disk replay
(``manager=``) is in ``test_torch_checkpoint.py``."""
import time
import warnings

import numpy as np
import pytest

from repro.core import generators as rgen
from repro.core.sssp.fleet import FleetSolver as RFleetSolver
from repro.core.sssp.fleet import build_fleet as rbuild_fleet
from repro.distributed import fault as rfault
from repro.runtime import fleet as rreplay
import repro_torch.sssp as P
from repro_torch.core import generators as pgen
from repro_torch.distributed import fault as pfault
from repro_torch.runtime import fleet as preplay
from test_torch_graph import _one_torch_thread  # noqa: F401

REPLAY = dict(seed=5, ckpt_every=2, queries_per_tick=4, straggler_z=1.2)
NOISY = ("straggler_sleep_s", "drift_s", "query_s", "stragglers_flagged")


def port_replay(fault, ticks=6, **kw):
    fleet = P.build_fleet([pgen.make("geometric", 100, seed=s)
                           for s in range(4)], device="cpu")
    rp = preplay.CongestionReplay(P.FleetSolver(fleet), fault=fault,
                                  **REPLAY, **kw)
    return rp, rp.run(ticks)


def ref_replay(fault, ticks=6):
    fleet = rbuild_fleet([rgen.make("geometric", 100, seed=s)
                          for s in range(4)])
    rp = rreplay.CongestionReplay(RFleetSolver(fleet), fault=fault,
                                  **REPLAY)
    return rp, rp.run(ticks)


def _quiet(stats):
    return {k: v for k, v in stats.items() if k not in NOISY}


def test_dropout_restart_bitwise():
    clean, st0 = port_replay(None)
    chaos, st = port_replay(pfault.FaultInjector({3: ("dropout", 0)}))
    ref, rst = ref_replay(rfault.FaultInjector({3: ("dropout", 0)}))
    assert st["restarts"] == 1 and st["chaos_events"] == 1
    assert np.array_equal(clean.weights(), chaos.weights())
    assert np.array_equal(clean.distances(), chaos.distances())
    assert np.array_equal(np.asarray(ref.weights()), chaos.weights())
    assert np.array_equal(np.asarray(ref.distances()), chaos.distances())
    assert _quiet(rst) == _quiet(st)
    assert st0["ticks"] == 6 and st["ticks"] == 7     # one tick replayed
    # and the resumed state is right: cold per-graph solves
    dist = chaos.distances()
    for i in range(chaos.fleet.size):
        cold = P.Solver(chaos.fleet.member(i), backend="segment",
                        device="cpu").solve(i % chaos.fleet.n)
        assert np.array_equal(dist[i], cold.dist.numpy())


def test_dropout_before_the_first_checkpoint_restores_the_baseline():
    clean, _ = port_replay(None, ticks=3)
    chaos, st = port_replay({1: ("dropout", 2)}, ticks=3)
    assert st["restarts"] == 1 and st["ticks"] == 4
    assert np.array_equal(clean.weights(), chaos.weights())
    assert np.array_equal(clean.distances(), chaos.distances())


def test_straggler_flagged_and_replay_stats():
    # two stalls on the same virtual host: a z-score outlier
    _, st = port_replay(pfault.FaultInjector({2: ("straggler", 60),
                                              6: ("straggler", 60)}),
                        ticks=8)
    assert st["stragglers_flagged"] >= 1
    assert st["restarts"] == 0 and st["chaos_events"] == 2
    assert st["ticks"] == 8 and st["queries"] == 8 * 4 * 4
    assert st["cache_hits"] > 0
    assert st["fleet_dispatches"] >= 8
    assert st["straggler_sleep_s"] == pytest.approx(0.12)


def test_drift_and_queries_match_the_reference():
    src = np.random.default_rng(0).integers(0, 50, 300)
    w = np.random.default_rng(1).uniform(0.1, 2, 300).astype(np.float32)
    for tick in range(3):
        kw = dict(seed=5, tick=tick, member=1, region=12, drift_edges=16)
        a, b = rreplay.regional_drift(src, w, 50, **kw), \
            preplay.regional_drift(src, w, 50, **kw)
        assert np.array_equal(a[0], b[0])
        assert a[1].dtype == b[1].dtype and np.array_equal(a[1], b[1])
        qk = dict(seed=5, tick=tick, member=2, count=6, hot_frac=0.5)
        hot = np.arange(8)
        assert rreplay.query_stream(50, hot, **qk) == \
            preplay.query_stream(50, hot, **qk)


# ---------------------------------------------------------------------------
# distributed/fault.py: the port's copy against the reference
# ---------------------------------------------------------------------------

def test_watchdog_fires_and_stays_quiet():
    with pytest.raises(pfault.StepTimeout):
        with pfault.StepWatchdog(timeout_s=0.05):
            time.sleep(0.15)
    with pfault.StepWatchdog(timeout_s=5.0) as wd:
        time.sleep(0.01)
    assert not wd.fired


def test_detect_stragglers_matches_reference():
    times = {f"host{i}": [0.10 + 0.001 * i] * 10 for i in range(16)}
    times["host13"] = [0.50] * 10
    uniform = {f"h{i}": [0.1] * 10 for i in range(16)}
    short = {f"h{i}": [0.1] * 2 for i in range(16)}
    for case in (times, uniform, short):
        assert pfault.detect_stragglers(case) == \
            rfault.detect_stragglers(case)
    assert pfault.detect_stragglers(times) == ["host13"]
    assert pfault.max_zscore_bound(4) == rfault.max_zscore_bound(4) == 1.5
    small = {f"h{i}": [0.10] * 10 for i in range(4)}
    small["h3"] = [0.50] * 10
    noisy = {f"h{i}": [0.10 + 0.004 * i] * 10 for i in range(4)}
    for case, want in ((small, ["h3"]), (noisy, [])):
        with pytest.warns(RuntimeWarning, match="maximum attainable"):
            got = pfault.detect_stragglers(case, z_threshold=3.0)
        with pytest.warns(RuntimeWarning):
            assert got == rfault.detect_stragglers(case, z_threshold=3.0)
        assert got == want
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pfault.detect_stragglers(small, z_threshold=1.2) == ["h3"]


def test_elastic_data_axis_and_dropout():
    for args in ((64, 4, 16), (63, 4, 16)):
        assert pfault.elastic_data_axis(*args) == \
            rfault.elastic_data_axis(*args)
    with pytest.raises(RuntimeError):
        pfault.elastic_data_axis(1, 4, model_parallel=16)
    e = pfault.DeviceDropout(3, 1)
    assert (e.tick, e.member) == (3, 1) and str(e) == str(
        rfault.DeviceDropout(3, 1))


def test_fault_injector_consume_once_and_step_timer():
    for mod in (pfault, rfault):
        fi = mod.FaultInjector({2: ("dropout", 0)})
        assert fi.poll(1) is None
        assert fi.poll(2) == ("dropout", 0)
        assert fi.poll(2) is None            # a replayed tick runs clean
        assert fi.events == [(2, "dropout", 0)]
        with pytest.raises(ValueError, match="unknown fault"):
            mod.FaultInjector({0: ("meteor", 1)})
    timer = pfault.StepTimer(window=3)
    assert timer.mean == 0.0
    for _ in range(5):
        timer.start()
        timer.stop()
    timer.stop()                             # a stop without a start: none
    assert len(timer.times) == 3 and timer.mean >= 0.0
