"""``repro_torch.sssp`` — the public SSSP surface of the port.

    from repro_torch import sssp

    solver = sssp.Solver(graph)             # CUDA unless device="cpu"
    res = solver.solve(0)                   # one source
    batch = solver.solve_batch([0, 7, 42])  # many sources, one run
    batch[1].path_to(99)                    # lazy parents/paths

Backends (``backend=``): "segment" (scatter-min over the dst-sorted edge
list), "ell"/"pallas" (dense in-neighbour layout through the fused ELL
relax and masked-min kernels), "frontier" (compacted sparse-frontier
rounds through the scatter-min kernel; "auto" picks it for
thin-wavefront graphs), "distributed" (the edge list sharded over the
ranks of a ``torch.distributed`` process group, ``group=``; the default
group if initialized, else a world of one):

    solver = sssp.Solver(graph, backend="distributed")   # on every rank
    solver.world, solver.collectives.calls               # ranks, all-reduces

Dynamic graphs (weight streams):

    dyn = sssp.DynamicSolver(graph)              # tracks full results
    dyn.solve_batch([0, 7])
    delta = sssp.make_delta(dyn.graph, idx, w)   # or random_delta
    dyn.update(delta)                            # warm re-solve, stats
    dyn.resolve([0, 7])                          # post-update distances

Targeted queries with landmark (ALT) seeds:

    index = sssp.LandmarkIndex(graph, k=8)       # d(L,.) and d(.,L)
    res = solver.solve(s, target=t, C0=index.seed(s))   # early exit
    res.dist[t]; res.path_to(t)                  # exact on the partial

Bidirectional point-to-point queries (forward from s, backward from t on
the transpose, two lanes of one run):

    bidi = sssp.BidirectionalSolver(graph)       # "auto": frontier on
    r = bidi.solve(s, t)                         #   road-like graphs
    r.distance; r.path(); r.meeting              # exact, stitched
    bidi = sssp.BidirectionalSolver(graph, landmarks=index)   # ALT seeds
    fresh = bidi.update(delta, warm=[(s, t, r.D, r.fixed)])    # pair cache

Graph fleets (F same-shape graphs, one run for all members):

    fleet = sssp.build_fleet([(n, src, dst, w), ...])   # common e_pad
    fs = sssp.FleetSolver(fleet)                 # "segment" | "frontier"
    res = fs.solve(sources)                      # one source a member
    res.result(2).path_to(7)
    fs.solve_batch(sources_FxB)                  # [F, B] lanes
    fs.update(sssp.stack_deltas([d0, d1, ...]))  # per-member deltas, warm
    fs.resolve()

Baselines (the paper's comparison points):

    sssp.run_bellman_ford(graph, s)              # .dist, .rounds
    sssp.run_delta_stepping(graph, s, delta=0.25)   # .phases, .light_iters

Serving (a query service over a DynamicSolver, with caches, landmark
seeds, bidirectional pairs and the wave planner):

    from repro_torch.runtime.sssp_service import Query, SSSPService
    svc = SSSPService(graph, batch=8, landmarks=8, planner=True,
                      bidirectional=True)       # device= as Solver's
    svc.serve([Query(s, t), Query(s2)])          # .distance/.path, .dist
    svc.apply_delta(delta)                       # warm hot sources, pairs

or ``python -m repro_torch.launch.serve_sssp --help``.

The legacy entry points ``run_sssp``, ``run_sssp_ell``,
``run_sssp_traced`` (eager rounds with a per-round trace:
``res.trace[i]["D"]``, ``["C"]``, ``["minD"]``, ...) and
``run_sssp_distributed`` (``(D, C, fixed, rounds)``) answer one source.
"""
from repro_torch.core.graph import (  # noqa: F401
    CsrGraph, EllGraph, Graph, HostGraph, build_csr, build_ell, build_graph)
from repro_torch.core.sssp.backends import Primitives  # noqa: F401
from repro_torch.core.sssp.bellman_ford import (  # noqa: F401
    BFResult, run_bellman_ford)
from repro_torch.core.sssp.bidirectional import (  # noqa: F401
    BidiResult, BidirectionalSolver)
from repro_torch.core.sssp.delta_stepping import (  # noqa: F401
    DeltaResult, run_delta_stepping)
from repro_torch.core.sssp.dynamic import (  # noqa: F401
    DynamicSolver, GraphDelta, make_delta, make_delta_from_endpoints,
    random_delta)
from repro_torch.core.sssp.distributed import (  # noqa: F401
    run_sssp_distributed)
from repro_torch.core.sssp.engine import (  # noqa: F401
    SP1_RULES, SP2_RULES, SP3_CONFIG, SP3_RULES, SP4_CONFIG, SSSPConfig,
    SSSPResult, run_sssp, run_sssp_ell, run_sssp_traced)
from repro_torch.core.sssp.fleet import (  # noqa: F401
    FleetBatchResult, FleetResult, FleetSolver, GraphFleet, build_fleet,
    stack_deltas)
from repro_torch.core.sssp.landmarks import (  # noqa: F401
    LandmarkIndex, ReselectPolicy, seed_lower_bounds, select_landmarks)
from repro_torch.core.sssp.parents import (  # noqa: F401
    extract_path, parent_pointers)
from repro_torch.core.sssp.reference import (  # noqa: F401
    dijkstra, sp1, sp2, sp3)
from repro_torch.core.sssp.solver import (  # noqa: F401
    BACKENDS, Solver, SSSPBatchResult)
