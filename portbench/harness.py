"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up (``setup_s``, from the start of the process): the configuration's
generator makes the graph on the device from the configuration's
``graph_seed``; its ``(n, src,
dst, w)`` arrays go to the host and into ``Solver((n, src, dst, w))``
with the default configuration and ``backend="auto"``, as users build
it (``layout_build_s`` is the constructor alone); one warm request of
the cell's own shape follows.

The window: one client in a closed loop sends the traffic's requests,
each timed on the host clock and ending in a synchronize, until
``seconds`` have passed; the request under way then finishes.  With
``trace`` the window's first ``TRACE_SECONDS`` run under
``torch.profiler``.

The check, once the window has closed and the solver is freed: every
request of the window is held lane by lane against
``reference.distances`` on the benchmark's own arrays.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import threading
import time

import numpy as np
import torch

from portbench import bench, reference, trace as tracing, traffic as mix

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HANG_GRACE_S = 60.0   # an answer may come this late after the window
TRACE_SECONDS = 5.0   # the traced part of a --trace 1 window (its start)


@dataclasses.dataclass(frozen=True)
class Request:
    start: float
    end: float
    sources: int
    rounds: int        # the most rounds of the request's lanes
    host_reads: int
    traced: bool


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers read it."""
    setup_s: float
    layout_build_s: float
    window_start: float
    requests: list[Request]
    trace: tracing.Summary | None = None


def seeds(seed: int, names=("roots", "warm")) -> dict[str, int]:
    """Independent 63-bit seeds, one for each named random stream."""
    state = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(
        len(names), np.uint64)
    return {k: int(v) >> 1 for k, v in zip(names, state)}


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_inputs(cell: bench.Cell, device: torch.device):
    """The cell's graph as host arrays ``(n, src int32, dst int32, w
    float32)`` and its root candidates, made on ``device`` from the
    configuration's ``graph_seed``: every run solves the same graph and
    the run's seed draws the requests, so the seed does not change the
    work."""
    seed = seeds(cell.config["graph_seed"], ("graph",))["graph"]
    n, src, dst, w = bench.generator(cell.config).make(cell.config, seed,
                                                       device)
    cands = mix.root_candidates(n, src)
    host = (n, src.to(torch.int32).cpu().numpy(),
            dst.to(torch.int32).cpu().numpy(), w.cpu().numpy())
    return host, cands


class Watchdog:
    """Ends the process, printing no result, if a request is still under
    way past the limit it was armed with: an answer may come late, up to
    ``HANG_GRACE_S`` past the window's close, but one that never comes
    must not hang the run."""

    def __init__(self):
        self.limit: float | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        while not self._stop.wait(1.0):
            limit = self.limit
            if limit is not None and time.perf_counter() > limit:
                log("a request did not return within a minute of the "
                    "window's close: no result")
                os._exit(4)

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool,
        device="cuda", t0: float | None = None) -> dict:
    """One run of ``cell``; returns the result line's object.  ``t0`` is
    the perf_counter at which set-up began (the process's start)."""
    from repro_torch.core.sssp.solver import Solver
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    sd = seeds(seed)
    tr = cell.traffic
    mix.validate(tr)

    phases = {"start": time.perf_counter() - t0}
    tp = time.perf_counter()
    (n, src, dst, w), cands = make_inputs(cell, device)
    phases["inputs"] = time.perf_counter() - tp
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    tl = time.perf_counter()
    solver = Solver((n, src, dst, w), device=device)
    _sync(device)
    layout_build_s = phases["solver"] = time.perf_counter() - tl
    log(f"{cell.name}: n {n}, e {src.size}, route {solver.backend}")
    print(f"[portbench] {cell.name} route={solver.backend} n={n} "
          f"e={src.size}", flush=True)
    tp = time.perf_counter()
    mix.send(solver, tr, mix.Requests(tr, cands, np.random.default_rng(
        sd["warm"])).next())
    _sync(device)
    phases["warm"] = time.perf_counter() - tp
    setup_s = time.perf_counter() - t0
    log("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f"; total {setup_s:.3f}")

    requests = mix.Requests(tr, cands, np.random.default_rng(sd["roots"]))
    answers: list[tuple[np.ndarray, torch.Tensor]] = []
    done: list[Request] = []
    failed = 0
    prof, trace_t0, trace_window = None, 0.0, 0.0
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        _sync(device)
        trace_t0 = time.perf_counter()
    dog = Watchdog()
    start = time.perf_counter()
    deadline = start + seconds
    tracing_on = prof is not None
    while time.perf_counter() < deadline:
        roots = requests.next()
        ts = time.perf_counter()
        dog.limit = deadline + HANG_GRACE_S
        try:
            dist, rounds, reads = mix.send(solver, tr, roots)
            _sync(device)
        except Exception as exc:   # a failed request is counted, not fatal
            log(f"request {len(done) + failed} failed: {exc!r}")
            failed += 1
            continue
        finally:
            dog.limit = None
        te = time.perf_counter()
        done.append(Request(ts, te, len(roots), rounds, reads, tracing_on))
        answers.append((roots, dist))
        if tracing_on and te - trace_t0 >= TRACE_SECONDS:
            prof.__exit__(None, None, None)
            trace_window, tracing_on = te - trace_t0, False
    if tracing_on:
        _sync(device)
        trace_window = time.perf_counter() - trace_t0
        prof.__exit__(None, None, None)
    dog.close()
    log(f"window: {len(done)} requests, {failed} failed, "
        f"{time.perf_counter() - start:.3f} s")
    if done:
        ms = sorted(1e3 * (r.end - r.start) for r in done)
        rounds = sorted(r.rounds for r in done)
        log(f"request ms min {ms[0]:.1f} median {ms[len(ms) // 2]:.1f} max "
            f"{ms[-1]:.1f}; rounds min {rounds[0]} median "
            f"{rounds[len(rounds) // 2]} max {rounds[-1]}")

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del solver
    dist = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    record = Record(setup_s, layout_build_s, start, done)
    if prof is not None:
        record.trace = tracing.summarize(*tracing.spans(prof), trace_window)
        del prof

    checks, wrong = check(n, src, dst, w, answers, device, failed)
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": len(done) + failed,
        "failed": failed + wrong,
        "metrics": metrics(cell, trace, record),
        "device": device_info(cell, device, peak, record.trace),
    }
    if record.trace is not None:
        result["breakdown"] = {"device_ops": record.trace.top_ops,
                               "idle_gaps": record.trace.idle_gaps}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def check(n, src, dst, w, answers, device, failed: int):
    """The numbers ``correct`` compares, each with its limit, and the
    number of ``answers`` (``(roots, distances)`` of each request) that
    were wrong."""
    tl = time.perf_counter()
    s = torch.from_numpy(src).to(device)
    d = torch.from_numpy(dst).to(device)
    wt = torch.from_numpy(w).to(device)
    bad = wrong = lanes = 0
    for roots, dist in answers:
        m = reference.mismatches(dist, reference.distances(n, s, d, wt,
                                                           roots))
        bad += m
        wrong += m > 0
        lanes += len(roots)
    log(f"reference: {len(answers)} requests, {lanes} lanes, "
        f"{time.perf_counter() - tl:.3f} s")
    return {
        "mismatched_distances": {"value": bad, "limit": 0, "ok": bad == 0},
        "failed_requests": {"value": failed, "limit": 0, "ok": failed == 0},
        "checked_lanes": {"value": lanes, "limit": ">= 1",
                          "ok": lanes >= 1},
    }, wrong


def metrics(cell: bench.Cell, trace: bool, record: Record) -> dict:
    out = {}
    for m in cell.metrics(trace):
        v = bench.reader(m)(record)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out


def device_info(cell: bench.Cell, device, peak: int,
                summary: tracing.Summary | None) -> dict:
    cuda = device.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax's, jaxlib's, flax's or
    the JAX package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def checks_text(result: dict) -> str:
    return "\n".join(f"check {k}: {c['value']} (limit {c['limit']})"
                     for k, c in result["checks"].items())
