"""Run every registered solver route on a probe graph and record it
(port of ``repro/analysis/routes.py``).

One small deterministic probe graph (the reference's: n 48, e 100, seed
7), every route the production stack can take: four backends x {cold,
targeted, batched, warm} where the backend supports the mode, the
distributed backend's batched and warm routes, the bidirectional pair
programs and the fleet programs.  Each route is the facade's own call
(``Solver.solve``, ``DynamicSolver.update``, ``FleetSolver.solve_batch``
...) run for the rounds it takes under an ``op_lint.Recorder``, so what
the linter sees is what a caller runs, on the CPU or the card.  A warm
route's deltas are built (on the host, as ``make_delta`` builds them)
before its run is recorded, as the reference traces only the warm
program.

The probe's edge list is padded to ``PROBE_EDGE_PAD`` (a prime) rather
than a multiple of 128, so no flattened frontier chunk (lanes x
vertices x degree) can equal ``e_pad`` and pass for a dense sweep; the
ELL row width stays 128.  The builder asserts that no vertex, batch,
frontier or CSR-degree dimension collides with an edge-layout one.
"""
from __future__ import annotations

import dataclasses
from fnmatch import fnmatch

import numpy as np

from repro_torch.analysis.op_lint import Recorder, RouteTrace

PROBE = dict(n=48, e=100, seed=7, frontier_cap=16, batch=4)
PROBE_EDGE_PAD = 101


@dataclasses.dataclass
class Route:
    """One recorded route, ready for the linter."""

    name: str
    trace: RouteTrace
    dense_dims: frozenset[int]     # edge-layout dims for the pass counter
    meta: dict


def _probe_graph(n: int = 48, e: int = 100, seed: int = 7):
    """Deterministic loop-free probe graph (host arrays), the
    reference's."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (src + rng.integers(1, n, e)) % n
    w = rng.uniform(0.1, 1.0, e).astype(np.float32)
    return n, src.astype(np.int64), dst.astype(np.int64), w


def _delta_for(graph):
    from repro_torch.core.sssp.dynamic import make_delta
    return make_delta(graph, [0, 1, 2], [0.5, 0.6, 0.7])


def build_routes(device="cuda", n: int = 48, e: int = 100, seed: int = 7,
                 frontier_cap: int = 16, batch: int = 4,
                 include: tuple[str, ...] = ("*",)) -> dict[str, Route]:
    """Run and record every solver route on the probe graph.

    ``device`` is where the routes run (``"cuda"``, the default, raises
    without a card, as every entry point does; there every recorded run
    is under torch's sync debug mode ``"error"``); ``include`` filters by fnmatch pattern
    (the CLI's ``--routes``).
    """
    from repro_torch.core.graph import build_graph, resolve_device
    from repro_torch.core.sssp.bidirectional import BidirectionalSolver
    from repro_torch.core.sssp.dynamic import DynamicSolver
    from repro_torch.core.sssp.fleet import (FleetSolver, build_fleet,
                                             stack_deltas)
    from repro_torch.core.sssp.solver import Solver

    dev = resolve_device(device)
    nn, src, dst, w = _probe_graph(n, e, seed)
    g = build_graph(nn, src, dst, w, edge_pad_multiple=PROBE_EDGE_PAD,
                    device=dev)
    e_pad = g.e_pad
    sources = [0, 5, 11, 23][:batch]
    routes: dict[str, Route] = {}

    def want(name: str) -> bool:
        return any(fnmatch(name, pat) for pat in include)

    with Recorder(sync_debug="error" if dev.type == "cuda"
                  else None) as rec:
        def add(name: str, run, dims, **meta) -> None:
            if want(name):
                with rec.record() as trace:
                    run()
                routes[name] = Route(name, trace,
                                     frozenset(int(d) for d in dims),
                                     dict(n=nn, e_pad=e_pad, **meta))

        # --- segment / ell / pallas / frontier: one Solver each -------
        for backend in ("segment", "ell", "pallas", "frontier"):
            if not any(want(f"{backend}.{m}") for m in
                       ("cold", "targeted", "batched", "warm")):
                continue
            kw = (dict(frontier_cap=frontier_cap)
                  if backend == "frontier" else {})
            sv = Solver(g, backend=backend, device=dev, **kw)
            # dense passes on the ELL layout sweep [n_pad, deg_pad] rows
            dims = ({sv.ell.deg_pad} if backend in ("ell", "pallas")
                    else {e_pad})
            sparse = ((sv.csr.max_out_deg, sv.csr.max_in_deg)
                      if sv.csr is not None else ())
            # cold from two sources: a dense round is one op sequence
            # whatever the source
            add(f"{backend}.cold", lambda: (sv.solve(0), sv.solve(5)),
                dims, sparse_dims=sparse)
            add(f"{backend}.targeted", lambda: sv.solve(0, target=5), dims,
                sparse_dims=sparse)
            add(f"{backend}.batched", lambda: sv.solve_batch(sources), dims,
                batch=batch, sparse_dims=sparse)
            if backend != "pallas" and want(f"{backend}.warm"):
                # pallas warm == ell warm: one backend in the port
                dyn = DynamicSolver(g, backend=backend, device=dev, **kw)
                dyn.solve_batch(sources[:2])
                delta = _delta_for(dyn.graph)
                add(f"{backend}.warm", lambda: dyn.update(delta), dims,
                    tracked=2, sparse_dims=sparse)

        # --- distributed: the world the backend runs without a group --
        if want("distributed.batched") or want("distributed.warm"):
            sd = DynamicSolver(g, backend="distributed", device=dev)
            local_e = sd.graph.e_pad // sd.world
            add("distributed.batched", lambda: sd.solve_batch(sources),
                {local_e}, batch=batch, world=sd.world)
            if want("distributed.warm"):
                sd.solve_batch(sources[:2])
                delta = _delta_for(sd.graph)
                add("distributed.warm", lambda: sd.update(delta),
                    {local_e}, tracked=2, world=sd.world)

        # --- bidirectional: the two-lane pair -------------------------
        if want("bidi.pair") or want("bidi.warm"):
            bidi = BidirectionalSolver(
                g, backend="segment", device=dev,
                rgraph=g.reverse(edge_pad_multiple=PROBE_EDGE_PAD))
            add("bidi.pair", lambda: bidi.solve(0, 5), {e_pad}, lanes=2)
            if want("bidi.warm"):
                r = bidi.solve(0, 5)
                delta = _delta_for(bidi.graph)
                rdelta = bidi.reverse_delta(delta)
                add("bidi.warm", lambda: bidi.update(
                    delta, rdelta, warm=[(0, 5, r.D, r.fixed)]),
                    {e_pad}, lanes=2)

        # --- fleet: [F] and [F, B] lanes ------------------------------
        fleet_modes = [f"{fam}.{m}" for fam in ("fleet", "fleet_frontier")
                       for m in ("cold", "batched", "warm")]
        if any(want(name) for name in fleet_modes):
            members = [(nn, src, dst, w),
                       (nn, src, dst, (w * 1.25).astype(np.float32))]
            fleet = build_fleet(members, edge_pad_multiple=PROBE_EDGE_PAD,
                                device=dev)
            F = fleet.size
            for fam, backend in (("fleet", "segment"),
                                 ("fleet_frontier", "frontier")):
                fs = FleetSolver(fleet, backend=backend,
                                 frontier_cap=frontier_cap)
                sparse = tuple(sorted({d for c in (fs.csrs or ())
                                       for d in (c.max_out_deg,
                                                 c.max_in_deg)}))
                add(f"{fam}.cold", lambda: fs.solve(sources[:F]),
                    {fleet.e_pad}, fleet=F, sparse_dims=sparse)
                add(f"{fam}.batched",
                    lambda: fs.solve_batch([sources] * F), {fleet.e_pad},
                    fleet=F, batch=batch, sparse_dims=sparse)
                if want(f"{fam}.warm"):
                    fs.solve(sources[:F])
                    deltas = stack_deltas([_delta_for(fleet.member(i))
                                           for i in range(F)])
                    add(f"{fam}.warm", lambda: fs.update(deltas),
                        {fleet.e_pad}, fleet=F, sparse_dims=sparse)

    # guard the dense-pass counter against dimension collisions: no
    # vertex/batch/frontier dimension may equal an edge-layout dim, and
    # (frontier routes) no CSR degree bound either
    for r in routes.values():
        for clash, what in (
                (r.dense_dims & {nn, nn + 1, batch, 2, frontier_cap},
                 "probe sizes"),
                (r.dense_dims & set(r.meta.get("sparse_dims", ())),
                 "probe CSR degree bounds")):
            if clash:
                raise ValueError(
                    f"{what} collide with edge dims for {r.name}: {clash} "
                    "— adjust build_routes probe parameters")
    return routes
