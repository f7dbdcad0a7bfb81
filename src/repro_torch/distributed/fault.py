"""Fault tolerance and straggler detection (the port's own copy of
``repro/distributed/fault.py``, numpy only).

At 1000+ nodes the failure model is: (a) hard node loss (process exits,
collective times out), (b) stragglers (a slow host stretches every
bulk-synchronous step), (c) data-pipeline stalls.  The hooks here:

  1. ``StepWatchdog`` wraps the blocking wait of a step and raises
     ``StepTimeout`` when it exceeds ``timeout_s`` (a hung collective
     means a dead peer): restart from the last checkpoint.
  2. ``detect_stragglers`` flags hosts whose mean step time is a z-score
     outlier, ``StepTimer`` feeds it; ``elastic_data_axis`` is the mesh
     that fits the surviving hosts.
  3. ``FaultInjector`` is a deterministic chaos schedule for replay
     drivers (``runtime/fleet.CongestionReplay``); ``DeviceDropout`` the
     injected device loss.
"""
from __future__ import annotations

import threading
import time

import numpy as np


class StepTimeout(RuntimeError):
    pass


class StepWatchdog:
    """Context manager that raises StepTimeout if the step wedges."""

    def __init__(self, timeout_s: float = 300.0):
        self.timeout_s = timeout_s
        self._timer: threading.Timer | None = None
        self.fired = False

    def _fire(self):
        self.fired = True

    def __enter__(self):
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()
        if self.fired and exc[0] is None:
            raise StepTimeout(
                f"step exceeded {self.timeout_s}s — likely a hung "
                "collective; restart from last checkpoint")
        return False


def max_zscore_bound(n_hosts: int) -> float:
    """The largest z-score any of ``n_hosts`` samples can attain.

    For F values standardized by their own sample mean and sample std
    (ddof=1), max_i (x_i - mu)/sd is bounded by (F-1)/sqrt(F) —
    attained when one value is extreme and the rest are equal.  A
    threshold at or above this ceiling can NEVER fire, however slow the
    straggler — the small-fleet blind spot."""
    return (n_hosts - 1) / float(np.sqrt(n_hosts))


#: a clamped detection additionally requires the host to be this many
#: times slower than the fleet median — the z-score alone is too noisy
#: near its ceiling (a uniform 4-host fleet crosses 0.9*ceiling ~20% of
#: the time on measurement noise; a real straggler is *materially* slow).
CLAMP_RATIO_GUARD = 1.5


def detect_stragglers(step_times: dict[str, list[float]],
                      z_threshold: float = 3.0,
                      min_steps: int = 5) -> list[str]:
    """Hosts whose mean step time is a z-score outlier vs the fleet.

    The z-score of the slowest of F hosts is mathematically bounded by
    ``(F-1)/sqrt(F)`` (= 1.5 at F=4, 2.67 at F=9), so the default
    ``z_threshold=3.0`` is unreachable for fleets of ~11 hosts or fewer
    and used to detect *nothing*, silently.  When the requested
    threshold is at or above the ceiling it is now clamped to 90% of
    the ceiling — with a loud RuntimeWarning — and, because a z-score
    that close to its ceiling is reachable by measurement noise alone,
    a clamped detection additionally requires the host's mean step time
    to exceed ``CLAMP_RATIO_GUARD``x the fleet median (a real straggler
    stretches every bulk-synchronous step; noise does not).  Thresholds
    below the ceiling keep the pure z-score semantics."""
    hosts = [h for h, t in step_times.items() if len(t) >= min_steps]
    if len(hosts) < 3:
        return []
    bound = max_zscore_bound(len(hosts))
    z, clamped = z_threshold, False
    if z >= bound:
        z, clamped = 0.9 * bound, True
        import warnings
        warnings.warn(
            f"detect_stragglers: z_threshold={z_threshold:g} is at or "
            f"above the maximum attainable z-score {bound:.3g} for "
            f"{len(hosts)} hosts ((F-1)/sqrt(F)) and could never flag "
            f"anything; clamping to {z:.3g} with a "
            f"{CLAMP_RATIO_GUARD:g}x-median guard.  Pass a smaller "
            "z_threshold for small fleets to silence this.",
            RuntimeWarning, stacklevel=2)
    means = np.array([np.mean(step_times[h]) for h in hosts])
    mu = np.mean(means)
    sd = np.std(means, ddof=1) + 1e-9
    med = np.median(means)
    return [
        h for h, m in zip(hosts, means)
        if (m - mu) / sd > z
        and (not clamped or m > CLAMP_RATIO_GUARD * med)
    ]


def elastic_data_axis(n_hosts_alive: int, chips_per_host: int,
                      model_parallel: int) -> tuple[int, int]:
    """Largest (data, model) mesh that fits the surviving hosts.

    model_parallel is fixed by the checkpointed layout; the data axis
    shrinks to what remains (batch is re-split deterministically)."""
    total = n_hosts_alive * chips_per_host
    data = total // model_parallel
    if data == 0:
        raise RuntimeError("not enough chips for the model-parallel group")
    return data, model_parallel


class DeviceDropout(RuntimeError):
    """Injected device loss: the tick's device state is gone; the driver
    must restore the last checkpoint and replay."""

    def __init__(self, tick: int, member: int):
        super().__init__(f"injected device dropout at tick {tick} "
                         f"(fleet member {member})")
        self.tick = tick
        self.member = member


class FaultInjector:
    """Deterministic chaos schedule for replay drivers.

    ``schedule`` maps tick -> ("dropout", member) or
    ("straggler", delay_ms).  ``poll(tick)`` returns the event due at
    that tick — ONCE.  Consume-once semantics matter because a dropout
    makes the driver restore a checkpoint and re-run the tick: without
    the ``fired`` set the same event would re-fire forever.  Replayed
    ticks after a restore therefore run clean, which is exactly the
    recovery contract (the re-run is the "restored device").
    """

    def __init__(self, schedule: dict[int, tuple[str, int]] | None = None):
        self.schedule = dict(schedule or {})
        for t, ev in self.schedule.items():
            if ev[0] not in ("dropout", "straggler"):
                raise ValueError(f"unknown fault kind {ev[0]!r} at tick {t}")
        self.fired: set[int] = set()
        self.events: list[tuple[int, str, int]] = []   # audit log

    def poll(self, tick: int) -> tuple[str, int] | None:
        """The fault due at ``tick``, or None; each tick fires once."""
        if tick in self.fired or tick not in self.schedule:
            return None
        self.fired.add(tick)
        ev = self.schedule[tick]
        self.events.append((tick, ev[0], ev[1]))
        return ev


class StepTimer:
    """Per-host rolling step timer feeding detect_stragglers."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self.times = self.times[-self.window:]
            self._t0 = None

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0
