"""The port's recorded solver routes (``repro_torch.analysis.routes``,
``op_lint``) on the reference's probe graph, on the CPU: the route names
are the reference's; every route PASSes its contracts with no waiver;
each route's host reads a round, dense passes a round and kernel entries
are pinned; a dense round issues one op sequence for two sources; and
the recorder's scopes on a toy run.
"""
import pytest

from repro.analysis.routes import build_routes as ref_build_routes
from repro_torch.analysis import check
from repro_torch.analysis.contracts import KNOWN_VIOLATIONS
from repro_torch.analysis.op_lint import (OpSite, Recorder, RoundStat,
                                          RouteTrace, dense_pass_count,
                                          lint_route)
from repro_torch.analysis.routes import (PROBE_EDGE_PAD, _probe_graph,
                                         build_routes)
from test_torch_graph import _one_torch_thread  # noqa: F401

ROUTES = ["bidi.pair", "bidi.warm", "distributed.batched",
          "distributed.warm", "ell.batched", "ell.cold", "ell.targeted",
          "ell.warm", "fleet.batched", "fleet.cold", "fleet.warm",
          "fleet_frontier.batched", "fleet_frontier.cold",
          "fleet_frontier.warm", "frontier.batched", "frontier.cold",
          "frontier.targeted", "frontier.warm", "pallas.batched",
          "pallas.cold", "pallas.targeted", "segment.batched",
          "segment.cold", "segment.targeted", "segment.warm"]

#: host reads a round: the loop's predicate, and in a frontier round the
#: two cone counts and the inWeight_nf walk count (c_prop_iters 1)
READS = {r: 3 if r.split(".")[0] in ("frontier", "fleet_frontier") else 1
         for r in ROUTES}
#: the most dense edge-layout sweeps a probe round makes
DENSE = {"segment": 8, "distributed": 8, "bidi": 8, "fleet": 8, "ell": 3,
         "pallas": 3, "frontier": 3, "fleet_frontier": 3}
#: kernel entries every round of a family calls
ENTRIES = {"ell": ("ops.relax_ell", "ops.masked_min_pair"),
           "pallas": ("ops.relax_ell", "ops.masked_min_pair"),
           "frontier": ("ops.frontier_relax_b",),
           "fleet_frontier": ("ops.frontier_relax_b",)}


@pytest.fixture(scope="module")
def recorded():
    check._import_governed_modules()
    routes = build_routes("cpu")
    return routes, {name: lint_route(name, r.trace, dense_dims=r.dense_dims)
                    for name, r in routes.items()}


def test_route_names_are_the_references(recorded):
    routes, _ = recorded
    assert sorted(routes) == ROUTES == sorted(ref_build_routes())


@pytest.mark.parametrize("route", ROUTES)
def test_route_passes_with_no_waiver(recorded, route):
    _, verdicts = recorded
    v = verdicts[route]
    assert KNOWN_VIOLATIONS == ()
    assert v.verdict == "PASS", [(x.rule, x.detail) for x in v.violations]
    assert not v.violations and v.rounds > 0
    assert "engine.round_body" in v.contracts


@pytest.mark.parametrize("route", ROUTES)
def test_route_reads_sweeps_and_entries_pinned(recorded, route):
    routes, verdicts = recorded
    v, trace = verdicts[route], routes[route].trace
    fam = route.split(".")[0]
    assert [r.host_reads for r in trace.rounds] == \
        [READS[route]] * len(trace.rounds)
    assert v.host_reads == v.read_budget == READS[route]
    assert v.dense_passes <= v.dense_budget == DENSE[fam]
    if fam not in ("frontier", "fleet_frontier"):
        assert v.dense_passes == DENSE[fam]       # every dense round
        assert v.round_programs == 1
    for i in range(len(trace.rounds)):
        sites = trace.round_sites(i)
        ops = {s.op for s in sites}
        # a frontier round whose union frontier overflowed the buffer
        # takes the dense relax (its 3 sweeps) in place of B2
        overflow = (fam in ("frontier", "fleet_frontier") and
                    dense_pass_count(sites, routes[route].dense_dims) == 3)
        if not overflow:
            assert set(ENTRIES.get(fam, ())) <= ops, (i, sorted(ops))
    # no kernel launches on the CPU: the plain versions stand in
    assert v.launches == {}


@pytest.mark.parametrize("backend", ["segment", "pallas"])
def test_dense_round_signature_same_for_two_sources(backend):
    """Every round of a dense solve, from either of two sources, issues
    the same op sequence with the same shapes and dtypes (what a CUDA
    graph captured over a round needs)."""
    from repro_torch.core.graph import build_graph
    from repro_torch.sssp import Solver
    g = build_graph(*_probe_graph(), edge_pad_multiple=PROBE_EDGE_PAD,
                    device="cpu")
    sigs = {}
    with Recorder() as rec:
        sv = Solver(g, backend=backend, device="cpu")
        for s in (0, 17):
            with rec.record() as trace:
                res = sv.solve(s)
            assert len(trace.rounds) == res.rounds > 2
            sigs[s] = {trace.round_signature(i)
                       for i in range(len(trace.rounds))}
    assert len(sigs[0]) == 1 and sigs[0] == sigs[17]


def test_recorder_scopes_and_restores():
    """Round, cond and counted-read scopes on a targeted segment solve;
    the wrappers are gone after the ``with`` block."""
    from repro_torch.core.graph import build_graph
    from repro_torch.core.sssp import engine
    from repro_torch.kernels import ops
    from repro_torch.sssp import Solver
    orig = (engine._round, engine._cond, ops.relax_ell,
            engine.SyncCounter._read)
    g = build_graph(*_probe_graph(), edge_pad_multiple=PROBE_EDGE_PAD,
                    device="cpu")
    with Recorder() as rec:
        assert engine._round is not orig[0]
        sv = Solver(g, backend="segment", device="cpu")
        with rec.record() as trace:
            res = sv.solve(0, target=5)
    assert (engine._round, engine._cond, ops.relax_ell,
            engine.SyncCounter._read) == orig
    assert len(trace.rounds) == res.rounds
    # one predicate read a round, the exit read and the stats read
    assert trace.reads == res.host_syncs == res.rounds + 2
    cond = {s.op for s in trace.sites if s.scope == "cond"}
    assert "aten.gather" in cond
    hot = {s.op for s in trace.sites if s.scope == "round"}
    assert "aten.scatter_reduce.amin" in hot and "aten.gather" not in hot
    with pytest.raises(RuntimeError, match="outside"):
        with Recorder().record():
            pass


def _site(op, scope="round", in_dims=(), out_dims=(), kernel=False,
          device="cpu", counted=False, dtypes=("float32",)):
    return OpSite(op, scope, kernel, counted, 0 if scope == "round" else -1,
                  in_dims, out_dims, dtypes, device)


def test_dense_pass_count_keys_on_dims():
    sites = [
        _site("aten.index_select", in_dims=((4, 49), (128,)),
              out_dims=((4, 128),)),                       # sweep (out)
        _site("aten.index", in_dims=((128,), (16, 4)),
              out_dims=((16, 4),)),                        # frontier walk
        _site("aten.scatter_reduce.amin", in_dims=((4, 49), (4, 128),
                                                   (4, 128)),
              out_dims=((4, 49),)),                        # sweep (in)
        _site("aten.cumsum", in_dims=((48,),), out_dims=((48,),)),
        _site("ops.relax_ell", in_dims=((4, 48), (48, 128)),
              out_dims=((4, 48),)),                        # B3 sweeps
        _site("ops.frontier_relax_b", in_dims=((4, 48), (128,)),
              out_dims=((4, 48),)),                        # B2 does not
        _site("aten.index_select", scope="outside",
              out_dims=((4, 128),)),                       # not a round
        _site("aten.index_select", kernel=True,
              out_dims=((4, 128),)),                       # kernel's own
    ]
    assert dense_pass_count(sites, frozenset({128})) == 3
    assert dense_pass_count(sites, frozenset({999})) == 0


def test_host_read_rules_by_device():
    """An uncounted ``_local_scalar_dense`` fails anywhere in a route; in
    a kernel entry's plain version on the CPU it is the stand-in's own,
    on the card it is the route's."""
    from repro_torch.analysis.contracts import ContractSpec
    spec = {"s": ContractSpec(name="s", forbid=("aten._local_scalar_dense",
                                                "d2h_copy"))}

    def verdict(*sites):
        trace = RouteTrace(sites=list(sites), rounds=[RoundStat(0)])
        return lint_route("x.cold", trace, specs=spec, waivers=())

    ok = verdict(_site("aten._local_scalar_dense", counted=True))
    assert ok.verdict == "PASS"
    assert verdict(_site("aten._local_scalar_dense", scope="outside")
                   ).verdict == "FAIL"
    assert verdict(_site("aten._local_scalar_dense", kernel=True)
                   ).verdict == "PASS"
    bad = verdict(_site("aten._local_scalar_dense", kernel=True,
                        device="cuda"))
    assert [x.rule for x in bad.violations] == [
        "forbid:aten._local_scalar_dense"]
    assert verdict(_site("d2h_copy", device="cuda")).verdict == "FAIL"


def test_launch_rule_fails_a_plain_fallback_on_the_card():
    """On the card a kernel entry that did not launch its kernel (its
    wrapper gave way to the plain version) is a violation; on the CPU
    the plain version is the path."""
    def verdict(device, launches):
        trace = RouteTrace(sites=[
            _site("ops.relax_ell", device=device),
            _site("ops.relax_ell", device=device),
            _site("ops.masked_min_pair", device=device)],
            rounds=[RoundStat(0)], launches=launches)
        return lint_route("pallas.cold", trace, specs={}, waivers=())

    assert verdict("cpu", {}).verdict == "PASS"
    assert verdict("cuda", {"relax_ell": 2, "masked_min_pair": 1}
                   ).verdict == "PASS"
    bad = verdict("cuda", {"relax_ell": 1, "masked_min_pair": 1})
    assert [x.rule for x in bad.violations] == ["launch:relax_ell"]
